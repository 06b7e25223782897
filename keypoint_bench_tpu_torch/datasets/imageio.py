"""Image decoding and resizing for the file-backed datasets without OpenCV:
the port's counterpart of the JAX loaders' `_imread_rgb` (cv2.imread with
IMREAD_COLOR, then cvtColor, then /255) and of cv2.resize with
INTER_LINEAR.

Decoded here: binary PNM (P5, P6, maxval 255) in numpy, and 8-bit
non-interlaced PNG (gray, gray + alpha, RGB, RGBA) with the stdlib's zlib
and the native loader's row unfilter (runtime/loader.cpp; Average and
Paeth run along a row, too slow in Python at KITTI's width). As
IMREAD_COLOR does, alpha is dropped and gray is replicated to RGB. Every
other file (JPEG, 16-bit, interlaced or palette PNG, ...) goes to cv2,
imported when such a file is read; where cv2 is absent that raises
ImportError naming cv2 and the file's format.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # gray, RGB, gray+alpha, RGBA
_PNG_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                    6: "RGBA"}


def _format_of(head: bytes, path) -> str:
    if head.startswith(_PNG_SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head[:2] in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        return f"PNM {head[:2].decode()}"
    if head.startswith(b"BM"):
        return "BMP"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head.startswith(b"RIFF") and head[8:12] == b"WEBP":
        return "WebP"
    return f"unknown format ({os.path.splitext(str(path))[1] or 'no suffix'})"


def _pnm_tokens(data: bytes, count: int):
    """The first `count` header tokens of a PNM and the offset just past
    the single whitespace byte that ends the header."""
    toks, pos, n = [], 0, len(data)
    while len(toks) < count:
        while pos < n and (data[pos:pos + 1].isspace() or
                           data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                while pos < n and data[pos:pos + 1] not in (b"\n", b"\r"):
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < n and not data[pos:pos + 1].isspace() and \
                data[pos:pos + 1] != b"#":
            pos += 1
        if start == pos:
            raise IOError("truncated PNM header")
        toks.append(data[start:pos])
    return toks, pos + 1


def decode_pnm(data: bytes):
    """uint8 [H, W, 1 or 3] of a binary P5/P6 PNM with maxval 255, or None
    for any other PNM."""
    (magic, w, h, maxv), off = _pnm_tokens(data, 4)
    if magic not in (b"P5", b"P6") or int(maxv) != 255:
        return None
    c = 3 if magic == b"P6" else 1
    w, h = int(w), int(h)
    raster = np.frombuffer(data, np.uint8, count=w * h * c, offset=off)
    return raster.reshape(h, w, c)


def _png_chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n


def decode_png(data: bytes):
    """(uint8 [H, W, C], None) of an 8-bit non-interlaced gray, gray+alpha,
    RGB or RGBA PNG; (None, what it is) for any other PNG."""
    from keypoint_bench_tpu_torch.runtime.loader import png_unfilter
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise IOError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        return None, f"{_PNG_COLOR_NAMES.get(color, color)} PNG"
    if depth != 8:
        return None, f"{depth}-bit PNG"
    if interlace:
        return None, "interlaced PNG"
    c = _PNG_CHANNELS[color]
    rows = png_unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return rows.reshape(h, w, c), None


def _cv2_rgb(path, what: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading {path} ({what}) needs cv2 (OpenCV), which is not "
            f"installed; binary PNM and 8-bit non-interlaced PNG decode "
            f"without it") from e
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"can not load: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def read_rgb_u8(path) -> np.ndarray:
    """uint8 [H, W, 3] RGB, as cv2.imread(path, IMREAD_COLOR) followed by
    cvtColor(BGR2RGB) gives it."""
    with open(path, "rb") as f:
        data = f.read()
    what = _format_of(data[:16], path)
    img = None
    if what == "PNG":
        img, what = decode_png(data)
    elif what in ("PNM P5", "PNM P6"):
        img = decode_pnm(data)
        what = f"{what} with maxval other than 255"
    if img is None:
        return _cv2_rgb(path, what)
    c = img.shape[2]
    if c == 1 or c == 2:                      # gray: replicate, drop alpha
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(..., COLOR_BGR2GRAY) on 8-bit data: OpenCV's 15-bit
    fixed point, (9798 R + 19235 G + 3735 B + 16384) >> 15."""
    v = rgb.astype(np.int32)
    y = (9798 * v[..., 0] + 19235 * v[..., 1] + 3735 * v[..., 2]
         + 16384) >> 15
    return y.astype(np.uint8)


def read_image(path, gray: bool = False) -> np.ndarray:
    """float32 [H, W, 3] RGB in [0, 1], or [H, W, 1] with gray: what the
    JAX loaders' `_imread_rgb` gives."""
    rgb = read_rgb_u8(path)
    if gray:
        return (rgb_to_gray_u8(rgb).astype("float32") / 255.0)[..., None]
    return rgb.astype("float32") / 255.0


def _linear_taps(n_in: int, n_out: int, clamp_weights: bool):
    """cv2.resize's INTER_LINEAR source index pairs and weights along one
    axis: the source coordinate f = (d + 0.5) * scale - 0.5 and its
    fraction in float64, the weights rounded to float32. Columns clamp
    index and weight at the edges; rows clamp only the index (cv2 reads a
    clipped row twice with both weights)."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    w1 = (f - i0).astype(np.float32)
    if clamp_weights:
        low = i0 < 0
        i0[low], w1[low] = 0, 0.0
        high = i0 >= n_in - 1
        i0[high], w1[high] = n_in - 1, 0.0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, i1, (np.float32(1) - w1).astype(np.float32), w1


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h)) with INTER_LINEAR on a float32 [H, W] or
    [H, W, C] image: half-pixel centres, clamped edges, no antialiasing on
    a downscale; a horizontal pass, then a vertical one, in float32. Keeps
    a channel axis of 1 (cv2 drops it)."""
    w, h = int(size[0]), int(size[1])
    src = np.asarray(img, np.float32)
    x0, x1, a0, a1 = _linear_taps(src.shape[1], w, True)
    y0, y1, b0, b1 = _linear_taps(src.shape[0], h, False)
    extra = (None,) * (src.ndim - 2)
    rows = src[:, x0] * a0[(slice(None),) + extra] + \
        src[:, x1] * a1[(slice(None),) + extra]
    col = (slice(None), None) + extra
    return (rows[y0] * b0[col] + rows[y1] * b1[col]).astype(np.float32)
