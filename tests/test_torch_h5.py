"""The port's HDF5 reader (keypoint_bench_tpu_torch/datasets/h5.py) against
h5py: files written here by h5py in every layout the reader's scope
names, each read back with h5py blocked in sys.modules and held equal to
h5py's own array bit for bit (dtype, byte order and shape included).
Every path outside the scope raises ValueError naming what it met. The
committed fixtures under tests/data/h5/ (tools/make_h5_fixtures.py) read
equal to their .npy arrays, and the files chip_smoke.py's `write_h5`
writes read back equal through h5py."""
import json
import os
import runpy
import sys

import numpy as np
import pytest

from keypoint_bench_tpu_torch.datasets import h5

h5py = pytest.importorskip("h5py")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "h5")
SMOKE = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                       run_name="not_main")

DTYPES = ("<f4", "<f8", "<i2", "|u1", ">f4", ">i8")
SHAPES = {"scalar": (), "1d": (29,), "2d": (17, 23)}
FILTERS = {"none": {}, "deflate": {"compression": "gzip"},
           "shuffle+deflate": {"compression": "gzip", "shuffle": True},
           "fletcher32": {"fletcher32": True}}


def _cases():
    out = []
    for libver in ("earliest", "latest"):
        for layout in ("compact", "contiguous", "chunked", "single_chunk"):
            for filt in FILTERS:
                if layout in ("compact", "contiguous") and filt != "none":
                    continue
                for shape in SHAPES:
                    if layout in ("chunked", "single_chunk") and \
                            shape == "scalar":
                        continue
                    for dt in DTYPES:
                        out.append(pytest.param(
                            libver, layout, filt, shape, dt,
                            id=f"{libver}-{layout}-{filt}-{shape}-{dt}"))
    return out


def _array(shape, dt, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 300, shape)
    if np.dtype(dt).kind != "f":
        a = rng.integers(0, 200, shape)
    return np.asarray(a).astype(dt)


def _h5py_array(path, name):
    with h5py.File(path, "r") as f:
        return np.array(f[name])


def _read_blocked(monkeypatch, path, name):
    """datasets/h5.py's read of name with h5py blocked, as on the card."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        return h5.read(path, name)


def _assert_bits_equal(got, want):
    assert got.dtype == want.dtype and got.dtype.str == want.dtype.str
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


@pytest.mark.parametrize("libver,layout,filt,shape,dt", _cases())
def test_layouts_read_bit_equal_to_h5py(tmp_path, monkeypatch, libver,
                                        layout, filt, shape, dt):
    a = _array(SHAPES[shape], dt)
    path = tmp_path / "t.h5"
    kw = dict(FILTERS[filt])
    if layout == "compact":
        kw["dcpl"] = _compact_dcpl()
    elif layout == "chunked":
        kw["chunks"] = tuple(max(1, s // 3) for s in a.shape)
    elif layout == "single_chunk":
        kw["chunks"] = a.shape
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("group/x", data=a, **kw)
    want = _h5py_array(path, "group/x")
    _assert_bits_equal(_read_blocked(monkeypatch, path, "/group/x"), want)
    np.testing.assert_array_equal(want, a)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_megadepth_files_read_bit_equal_to_h5py(tmp_path, monkeypatch,
                                                libver):
    """MegaDepth's own names and shapes: /depth at 1066 x 1600 float32 in
    one file, K, R, T float64 in another, as h5py writes them by default."""
    rng = np.random.default_rng(1)
    depth = rng.uniform(0, 80, (1066, 1600)).astype("f4")
    calib = {"K": np.array([[1000.0, 0, 800], [0, 1000.0, 533],
                            [0, 0, 1]]),
             "R": np.linalg.qr(rng.normal(size=(3, 3)))[0],
             "T": rng.normal(size=3)}
    with h5py.File(tmp_path / "d.h5", "w", libver=libver) as f:
        f.create_dataset("/depth", data=depth)
    with h5py.File(tmp_path / "c.h5", "w", libver=libver) as f:
        for k, v in calib.items():
            f.create_dataset(k, data=v)
    _assert_bits_equal(_read_blocked(monkeypatch, tmp_path / "d.h5",
                                     "/depth"),
                       _h5py_array(tmp_path / "d.h5", "/depth"))
    for k in calib:
        _assert_bits_equal(_read_blocked(monkeypatch, tmp_path / "c.h5", k),
                           _h5py_array(tmp_path / "c.h5", k))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("fill", [None, 3.5])
@pytest.mark.parametrize("kind", ["contiguous", "chunked", "chunked_partly",
                                  "chunked_deflate_partly"])
def test_unallocated_data_reads_as_the_fill_value(tmp_path, monkeypatch,
                                                  libver, fill, kind):
    path = tmp_path / "u.h5"
    kw = {} if fill is None else {"fillvalue": fill}
    if kind != "contiguous":
        kw["chunks"] = (4, 6)
    if "deflate" in kind:
        kw["compression"] = "gzip"
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset("x", shape=(10, 15), dtype="f4", **kw)
        if "partly" in kind:
            d[3:6, 5:13] = np.arange(24, dtype="f4").reshape(3, 8)
    want = _h5py_array(path, "x")
    _assert_bits_equal(_read_blocked(monkeypatch, path, "x"), want)
    assert (want == (fill or 0.0)).any()


@pytest.mark.parametrize("written", ["all", "one page"])
def test_paged_fixed_array_index(tmp_path, monkeypatch, written):
    """More chunks than a fixed-array page holds (1024): the index is
    paged, and a page no chunk was written to is left uninitialized."""
    path = tmp_path / "p.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", shape=(2600,), dtype="f4", chunks=(1,),
                             fillvalue=-2.0)
        if written == "all":
            d[:] = np.arange(2600, dtype="f4")
        else:
            d[1500:1510] = 7.0
    _assert_bits_equal(_read_blocked(monkeypatch, path, "x"),
                       _h5py_array(path, "x"))


@pytest.mark.parametrize("filtered", [False, True])
def test_paged_fixed_array_of_filtered_chunks(tmp_path, monkeypatch,
                                              filtered):
    path = tmp_path / "p.h5"
    kw = {"compression": "gzip", "fletcher32": True} if filtered else {}
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3 * 1100, dtype="<i4")
                         .reshape(1100, 3), chunks=(1, 3), **kw)
    _assert_bits_equal(_read_blocked(monkeypatch, path, "x"),
                       _h5py_array(path, "x"))


def test_implicit_chunk_index(tmp_path, monkeypatch):
    """Chunks allocated early and unfiltered (libver latest): the implicit
    index, chunks stored one after another."""
    path = tmp_path / "i.h5"
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((4, 4))
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(90.0).reshape(9, 10),
                         dcpl=dcpl)
    _assert_bits_equal(_read_blocked(monkeypatch, path, "x"),
                       _h5py_array(path, "x"))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_groups_and_header_continuations(tmp_path, monkeypatch, libver):
    """Nested groups; a symbol table of 30 names (several SNODs under the
    B-tree) or 8 link messages; attributes added after the data, which
    push the object headers into continuation blocks."""
    path = tmp_path / "g.h5"
    n = 30 if libver == "earliest" else 8
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("a/b")
        for i in range(n):
            g.create_dataset(f"n{i:02d}", data=np.arange(i + 1.0))
        x = f.create_dataset("c", data=np.arange(6.0), chunks=(2,),
                             compression="gzip")
        for i in range(8):
            x.attrs[f"a{i}"] = np.arange(100)
            f.attrs[f"r{i}"] = np.arange(100)
        f["z"] = np.arange(5)
    names = [f"a/b/n{i:02d}" for i in range(n)] + ["c", "z", "/z"]
    for name in names:
        _assert_bits_equal(_read_blocked(monkeypatch, path, name),
                           _h5py_array(path, name))
    assert sorted(h5.File(path).keys()) == ["a", "c", "z"]


def test_superblock_v2_and_user_block(tmp_path, monkeypatch):
    a = _array((5, 7), "<f8")
    with h5py.File(tmp_path / "v2.h5", "w", libver=("v108", "latest")) as f:
        f["x"] = a
    with h5py.File(tmp_path / "ub.h5", "w", userblock_size=1024) as f:
        f.create_dataset("x", data=a, chunks=(2, 3), compression="gzip")
    for name, version in (("v2.h5", 2), ("ub.h5", 0)):
        path = tmp_path / name
        head = path.read_bytes()
        at = head.index(b"\x89HDF\r\n\x1a\n")
        assert head[at + 8] == version
        _assert_bits_equal(_read_blocked(monkeypatch, path, "x"),
                           _h5py_array(path, "x"))


def test_a_missing_name_raises_key_error(tmp_path):
    with h5py.File(tmp_path / "m.h5", "w") as f:
        f["x"] = np.arange(3)
    with pytest.raises(KeyError, match="nope"):
        h5.read(tmp_path / "m.h5", "nope")


def _unsupported(kind, path):
    """Write a file that lies outside the reader's scope; returns (name,
    the message it must raise)."""
    with h5py.File(path, "w", libver="latest") as f:
        if kind == "extensible array":
            f.create_dataset("x", data=np.arange(10.0), chunks=(4,),
                             maxshape=(None,))
            return "x", "extensible array chunk index"
        if kind == "v2 B-tree":
            f.create_dataset("x", data=np.ones((4, 4)), chunks=(2, 2),
                             maxshape=(None, None))
            return "x", "v2 B-tree chunk index"
        if kind == "lzf":
            f.create_dataset("x", data=np.arange(100.0), chunks=(10,),
                             compression="lzf")
            return "x", r"filter 32000 \(lzf\)"
        if kind == "scaleoffset":
            f.create_dataset("x", data=np.arange(100), chunks=(10,),
                             scaleoffset=0)
            return "x", r"filter 6 \(scaleoffset\)"
        if kind == "string":
            f["x"] = np.array([b"ab", b"cd"])
            return "x", "string datatype"
        if kind == "compound":
            f["x"] = np.zeros(3, [("a", "<f4"), ("b", "<i4")])
            return "x", "compound datatype"
        if kind == "enum":
            f["x"] = np.array([True, False])
            return "x", "enum datatype"
        if kind == "dense links":
            for i in range(12):
                f[f"n{i}"] = np.arange(2)
            return "n3", "dense link storage"
        if kind == "soft link":
            f["x"] = np.arange(2)
            f["y"] = h5py.SoftLink("/x")
            return "y", "soft link"
        if kind == "external link":
            f["y"] = h5py.ExternalLink("other.h5", "/x")
            return "y", "external link"
        if kind == "null dataspace":
            f["x"] = h5py.Empty("f4")
            return "x", "null dataspace"
        if kind == "committed datatype":
            f["t"] = np.dtype("<f4")
            f.create_dataset("x", data=np.arange(3.0), dtype=f["t"])
            return "x", "shared message"
        if kind == "group":
            f.create_group("g")
            return "g", "not a dataset"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "extensible array", "v2 B-tree", "lzf", "scaleoffset", "string",
    "compound", "enum", "dense links", "soft link", "external link",
    "null dataspace", "committed datatype", "group"])
def test_outside_the_scope_raises_value_error(tmp_path, monkeypatch, kind):
    name, match = _unsupported(kind, tmp_path / "x.h5")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        with pytest.raises(ValueError, match=match):
            h5.read(tmp_path / "x.h5", name)


def test_a_corrupt_fletcher32_chunk_raises(tmp_path):
    path = tmp_path / "f.h5"
    a = np.arange(64, dtype="<f4")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=a, chunks=(64,), fletcher32=True)
    raw = bytearray(path.read_bytes())
    at = bytes(raw).index(a[5:9].tobytes())
    raw[at] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="fletcher32"):
        h5.read(path, "x")


def test_not_an_hdf5_file_raises(tmp_path):
    (tmp_path / "n.h5").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(2000))
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5.read(tmp_path / "n.h5", "x")


def test_fletcher32_matches_the_library_on_odd_lengths(tmp_path):
    """The checksum over 1-byte elements of odd and long lengths (past the
    360-word fold), as the library stores it in each chunk."""
    for n in (1, 7, 719, 720, 721, 5001):
        path = tmp_path / f"f{n}.h5"
        a = np.random.default_rng(n).integers(0, 256, n).astype("|u1")
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=a, chunks=(n,), fletcher32=True)
        raw = path.read_bytes()
        at = raw.index(a.tobytes())
        assert h5.fletcher32(a.tobytes()) == int.from_bytes(
            raw[at + n:at + n + 4], "little")


def _manifest():
    with open(os.path.join(FIXTURES, "MANIFEST.json")) as f:
        m = json.load(f)
    return [(fname, name, npy) for fname, e in sorted(m.items())
            for name, npy in sorted(e["datasets"].items())]


@pytest.mark.parametrize("fname,name,npy", _manifest(),
                         ids=lambda v: str(v))
def test_committed_fixtures_equal_their_npy(monkeypatch, fname, name, npy):
    path = os.path.join(FIXTURES, fname)
    want = np.load(os.path.join(FIXTURES, npy))
    _assert_bits_equal(_h5py_array(path, name), want)
    _assert_bits_equal(_read_blocked(monkeypatch, path, name), want)


def test_chip_smoke_fixture_check_reads_every_fixture(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    seen = SMOKE["h5_fixture_check"]()
    assert sum(len(v) for v in seen.values()) == len(_manifest())


def test_chip_smoke_writer_reads_back_through_h5py(tmp_path, monkeypatch):
    """`write_h5` (superblock 0, v1 headers, a symbol-table root group,
    contiguous data) as h5py reads it, and as datasets/h5.py does."""
    rng = np.random.default_rng(2)
    data = {"/depth": rng.uniform(0, 9, (37, 53)).astype("f4"),
            "K": rng.normal(size=(3, 3)), "R": np.eye(3),
            "T": rng.normal(size=3), "s": np.float64(3.5),
            "i": np.arange(-4, 5, dtype="<i2"),
            "u": np.arange(6, dtype="|u1").reshape(2, 3),
            "h": np.arange(4, dtype="<f2")}
    data.update({f"z{i:02d}": np.full(i, i, "<i4") for i in range(1, 12)})
    path = tmp_path / "w.h5"
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        SMOKE["write_h5"](path, data)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(k.strip("/") for k in data)
        for k, v in data.items():
            got = np.array(f[k])
            _assert_bits_equal(got, np.asarray(v))
            _assert_bits_equal(h5.read(path, k), got)
