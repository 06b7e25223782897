"""datasets/imageio.py, the port's image decoding without OpenCV, against
cv2 on the CPU: bit-equal to cv2.imread(IMREAD_COLOR) + cvtColor (BGR2RGB,
or BGR2GRAY with `gray`) + /255 on 8-bit PNGs written with each of the
five row filters (this file's encoder forces one a file) in each colour
type, and on binary P5 / P6 PNM; resize_linear against cv2.resize
(INTER_LINEAR) at up-, down-, integer and non-integer scales within
RESIZE_TOL (the weights are cv2's, rounded to float32 from float64; one
float32 ulp of [0, 1] measured); with cv2 blocked (the card's machine has
no OpenCV) PNG and PNM still decode, and the formats it leaves to cv2
raise ImportError naming cv2 and the format."""
import struct
import sys
import zlib

import numpy as np
import pytest

from keypoint_bench_tpu_torch.datasets import imageio

cv2 = pytest.importorskip("cv2")

RESIZE_TOL = 1e-6
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # gray, RGB, gray + alpha, RGBA


def png_bytes(img, filt, color, extra=b""):
    """An 8-bit PNG of img [H, W, C] whose every scanline uses filter type
    `filt`; `extra` chunks go before the image data."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    lines, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        row = a[y]
        left = np.concatenate([np.zeros(c, np.int32), row[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        pred = (0, left, prev, (left + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul)))[filt]
        lines.append(bytes([filt]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = zlib.compress(b"".join(lines))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + extra + chunk(b"IDAT", data[:len(data) // 2])
            + chunk(b"IDAT", data[len(data) // 2:]) + chunk(b"IEND", b""))


def _cv2_read(path, gray=False):
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if gray:
        return (cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype("float32")
                / 255.0)[..., None]
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype("float32") / 255.0


@pytest.mark.parametrize("filt", range(5), ids=["none", "sub", "up",
                                                  "average", "paeth"])
@pytest.mark.parametrize("color", [0, 2, 4, 6],
                         ids=["gray", "rgb", "gray_alpha", "rgba"])
def test_png_bit_equal_cv2(tmp_path, color, filt):
    rng = np.random.default_rng(color * 5 + filt)
    img = rng.integers(0, 256, (37, 53, CHANNELS[color]), dtype=np.uint8)
    path = tmp_path / "img.png"
    path.write_bytes(png_bytes(img, filt, color))
    for gray in (False, True):
        got = imageio.read_image(path, gray)
        assert got.dtype == np.float32
        assert np.array_equal(got, _cv2_read(path, gray))


@pytest.mark.parametrize("magic,c,comment", [("P6", 3, False),
                                             ("P6", 3, True),
                                             ("P5", 1, True)])
def test_pnm_bit_equal_cv2(tmp_path, magic, c, comment):
    img = np.random.default_rng(3).integers(0, 256, (41, 67, c),
                                            dtype=np.uint8)
    path = tmp_path / "img.pnm"
    head = f"{magic}\n" + ("# made by a test\n" if comment else "") + \
        "67 41\n255\n"
    path.write_bytes(head.encode() + img.tobytes())
    for gray in (False, True):
        assert np.array_equal(imageio.read_image(path, gray),
                              _cv2_read(path, gray))


def test_cv2_written_png_and_gray_rounding(tmp_path):
    """A PNG as OpenCV's own encoder writes it (its adaptive filters), and
    the 8-bit gray conversion on every RGB triple's rounding case."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "cv.png"), img)
    for gray in (False, True):
        assert np.array_equal(imageio.read_image(tmp_path / "cv.png", gray),
                              _cv2_read(tmp_path / "cv.png", gray))
    rgb = rng.integers(0, 256, (1, 100000, 3), dtype=np.uint8)
    assert np.array_equal(imageio.rgb_to_gray_u8(rgb),
                          cv2.cvtColor(rgb[..., ::-1].copy(),
                                       cv2.COLOR_BGR2GRAY))


RESIZES = [((48, 64), (32, 24)), ((48, 64), (100, 77)), ((48, 64), (64, 48)),
           ((37, 53), (20, 13)), ((64, 64), (32, 32)), ((376, 1241), (512, 512)),
           ((30, 40), (120, 90)), ((600, 800), (512, 512))]


@pytest.mark.parametrize("src,size", RESIZES,
                         ids=[f"{s[1]}x{s[0]}-{d[0]}x{d[1]}"
                              for s, d in RESIZES])
@pytest.mark.parametrize("channels", [3, 1, None])
def test_resize_linear_matches_cv2(src, size, channels):
    shape = src + ((channels,) if channels else ())
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    got = imageio.resize_linear(img, size)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.float32
    if channels == 1:                    # cv2 drops a single channel axis
        want = want[..., None]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RESIZE_TOL


def test_decodes_without_cv2(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    (tmp_path / "a.png").write_bytes(png_bytes(img, 4, 2))
    (tmp_path / "a.ppm").write_bytes(b"P6\n30 20\n255\n" + img.tobytes())
    want = [imageio.read_image(tmp_path / n) for n in ("a.png", "a.ppm")]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for n, w in zip(("a.png", "a.ppm"), want):
        assert np.array_equal(imageio.read_image(tmp_path / n), w)
    assert np.array_equal(want[0], img.astype(np.float32) / 255.0)


def _other_files(tmp_path):
    """Files imageio leaves to cv2, with the format each names."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "b16.png"), img.astype(np.uint16) * 257)
    colors = bytes([10, 200, 30, 250, 40, 90])          # two RGB entries
    palette = struct.pack(">I", 6) + b"PLTE" + colors + \
        struct.pack(">I", zlib.crc32(b"PLTE" + colors))
    idx = rng.integers(0, 2, (16, 24, 1), dtype=np.uint8)
    (tmp_path / "pal.png").write_bytes(png_bytes(idx, 0, 3, extra=palette))
    (tmp_path / "a.bmp").write_bytes(cv2.imencode(".bmp", img)[1].tobytes())
    return {"a.jpg": "JPEG", "b16.png": "16-bit PNG",
            "pal.png": "palette PNG", "a.bmp": "BMP"}


def test_other_formats_go_to_cv2(tmp_path):
    for name in _other_files(tmp_path):
        for gray in (False, True):
            assert np.array_equal(imageio.read_image(tmp_path / name, gray),
                                  _cv2_read(tmp_path / name, gray)), name


def test_other_formats_raise_naming_cv2_without_it(tmp_path, monkeypatch):
    files = _other_files(tmp_path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, what in files.items():
        with pytest.raises(ImportError, match=f"cv2.*{what}|{what}.*cv2"):
            imageio.read_image(tmp_path / name)
