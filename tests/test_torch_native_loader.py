"""The port's native loader (runtime/loader.cpp, built with g++ into
keypoint_bench_tpu_torch/_build/) against the JAX package's: PNM decode
and resize bit-equal on tests/test_native_loader.py's cases and on P5,
comment lines and odd sizes; the ordered prefetcher bit-equal; against
the port's numpy decode + resize_linear within `loader_tol` (the loader
computes its source coordinates in float32, resize_linear in float64 as
cv2 does, so a weight may be off by a few float32 ulps of the source
coordinate: 4 ulps of the larger source side, plus 1e-6, on values in
[0, 1]); a failed build raises with the compiler's output."""
import os

import numpy as np
import pytest

from keypoint_bench_tpu.runtime import loader as jax_loader
from keypoint_bench_tpu_torch.datasets import imageio
from keypoint_bench_tpu_torch.runtime import loader



def loader_tol(h, w):
    return 4 * max(h, w) * 2.0 ** -24 + 1e-6


def _write_pnm(path, img, comments=False):
    h, w, c = img.shape
    head = f"P{6 if c == 3 else 5}\n"
    if comments:
        head += "# a comment line\n"
    head += f"{w} {h}\n" + ("# another\n" if comments else "") + "255\n"
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(img.tobytes())


@pytest.fixture(scope="module")
def pnm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pnm")
    rng = np.random.default_rng(0)
    files = []
    for i, (h, w, c, com) in enumerate(((48, 64, 3, False), (48, 64, 3, True),
                                        (37, 53, 1, True), (61, 29, 3, True),
                                        (48, 64, 1, False), (20, 90, 3, False))):
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        p = str(d / f"img{i}.{'ppm' if c == 3 else 'pgm'}")
        _write_pnm(p, img, com)
        files.append((p, img))
    return files


SIZES = [(64, 48), (32, 24), (100, 77), (13, 20), (512, 512), (1, 1)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("i", range(6))
def test_load_pnm_resized_bit_equal_jax(pnm_files, i, size):
    path, img = pnm_files[i]
    got = loader.load_pnm_resized(path, *size)
    want = jax_loader.load_pnm_resized(path, *size)
    assert got.shape == (size[1], size[0], 3) and got.dtype == np.float32
    assert np.array_equal(got, want)
    # the numpy decode + resize_linear, the loader's counterpart in Python
    ref = imageio.resize_linear(imageio.read_image(path), size)
    assert np.abs(got - ref).max() <= loader_tol(*img.shape[:2])


def test_identity_size_is_the_image(pnm_files):
    path, img = pnm_files[0]
    got = loader.load_pnm_resized(path, 64, 48)
    assert np.array_equal(got, img.astype(np.float32) / np.float32(255))


@pytest.mark.parametrize("threads,capacity", [(1, 1), (3, 2), (4, 8)])
def test_prefetcher_ordered_and_bit_equal_jax(pnm_files, threads, capacity):
    paths = [p for p, _ in pnm_files] * 2
    want = dict(iter(jax_loader.NativePrefetcher(paths, 40, 30, n_threads=2)))
    seen = []
    with loader.NativePrefetcher(paths, 40, 30, n_threads=threads,
                                 capacity=capacity) as pf:
        for idx, frame in pf:
            seen.append(idx)
            assert np.array_equal(frame, want[idx])
    assert seen == list(range(len(paths)))


def test_prefetcher_reports_a_file_that_does_not_decode(pnm_files, tmp_path):
    bad = tmp_path / "bad.ppm"
    bad.write_bytes(b"P3\n2 2\n255\n0 0 0 0")
    paths = [pnm_files[0][0], str(bad)]
    with loader.NativePrefetcher(paths, 8, 8) as pf:
        it = iter(pf)
        assert next(it)[0] == 0
        with pytest.raises(IOError, match="bad.ppm"):
            next(it)
    with pytest.raises(IOError, match="bad.ppm"):
        loader.load_pnm_resized(str(bad), 8, 8)


def test_s2d_layout_and_bad_sizes_raise(pnm_files):
    paths = [pnm_files[0][0]]
    with pytest.raises(ValueError, match="space-to-depth"):
        loader.NativePrefetcher(paths, 64, 48, s2d_block=4)
    with pytest.raises(ValueError, match="positive"):
        loader.load_pnm_resized(paths[0], 0, 48)


def test_builds_only_into_the_ports_build_dir():
    path = loader.library_path()
    port = os.path.dirname(os.path.dirname(os.path.abspath(loader.__file__)))
    assert os.path.dirname(path) == os.path.join(port, "_build")
    assert loader.native_available()
    assert os.path.exists(path)


def test_failed_build_raises_with_the_compilers_error(monkeypatch, tmp_path):
    src = tmp_path / "loader.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(loader, "_SRC", str(src))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_error", None)
    with pytest.raises(RuntimeError, match="(?s)loader.cpp failed.*error"):
        loader.load_pnm_resized("x.ppm", 8, 8)
    assert not loader.native_available()
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        loader.NativePrefetcher(["x.ppm"], 8, 8)
