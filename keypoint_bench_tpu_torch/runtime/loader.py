"""ctypes binding of the port's native loader (runtime/loader.cpp): P5/P6
decode + bilinear resize to [0,1] float RGB, one image or through an
ordered threaded prefetcher, and the PNG row unfilter of
datasets/imageio.py. The port's own copy of
keypoint_bench_tpu/runtime/loader.py, without the space-to-depth layout.

The library is built with g++ at first use into
`keypoint_bench_tpu_torch/_build/` (git-ignored), keyed by a hash of the
source and the flags, and lands under its final name by an atomic rename.
A failed build raises RuntimeError with the compiler's output;
`native_available()` reports whether the library builds and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# the JAX package's flags, so the decode and resize arithmetic compiles the
# same way and the frames are bit-equal
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib = None
_error = None


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native "
                       "loader is built from runtime/loader.cpp")


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libkbt_loader_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Path of the built library, building it if needed; raises
    RuntimeError naming the compiler's error."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, _SRC,
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building runtime/loader.cpp failed (rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    """The loaded library; raises RuntimeError if it does not build."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        _error = f"native loader unavailable: {e}"
        raise RuntimeError(_error) from e
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.kbt_prefetcher_create.restype = ctypes.c_void_p
    lib.kbt_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.kbt_prefetcher_next.restype = ctypes.c_int64
    lib.kbt_prefetcher_next.argtypes = [ctypes.c_void_p, c_float_p,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.kbt_prefetcher_destroy.restype = None
    lib.kbt_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.kbt_load_pnm_resized.restype = ctypes.c_int
    lib.kbt_load_pnm_resized.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, c_float_p]
    lib.kbt_png_unfilter.restype = ctypes.c_int
    lib.kbt_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _out_size(out_w: int, out_h: int):
    out_w, out_h = int(out_w), int(out_h)
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"output size must be positive: {out_w}x{out_h}")
    return out_w, out_h


def load_pnm_resized(path: str, out_w: int, out_h: int) -> np.ndarray:
    """Decode a P5/P6 PNM (maxval 255) and resize it bilinearly to
    (out_h, out_w, 3) float32 RGB in [0,1] (cv2.resize's half-pixel
    convention; a gray image is replicated to RGB)."""
    lib = _load()
    out_w, out_h = _out_size(out_w, out_h)
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.kbt_load_pnm_resized(
        os.fsencode(path), out_w, out_h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"failed to decode {path} (a binary P5/P6 PNM with "
                      f"maxval 255 is expected)")
    return out


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The reconstructed [h, stride] uint8 scanlines of an inflated PNG
    image stream (each scanline 1 + stride bytes, its filter type first)."""
    lib = _load()
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h} x {stride + 1}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    if lib.kbt_png_unfilter(src.ctypes.data, h, stride, bpp,
                            out.ctypes.data) != 0:
        raise ValueError("PNG scanline with an unknown filter type")
    return out


class NativePrefetcher:
    """Ordered multi-threaded decode + resize over a path list: iterating
    yields (index, frame [out_h, out_w, 3] float32) in path order, and
    raises IOError naming a file that does not decode."""

    def __init__(self, paths, out_w: int, out_h: int, n_threads: int = 2,
                 capacity: int = 4, s2d_block: int = 0):
        self._handle = None
        if int(s2d_block) > 1:
            raise ValueError("the space-to-depth output layout (s2d_block) "
                             "is a TPU layout the port does not produce")
        self._lib = _load()
        out_w, out_h = _out_size(out_w, out_h)
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._n = len(self._paths)
        self._shape = (out_h, out_w, 3)
        self._handle = self._lib.kbt_prefetcher_create(
            arr, self._n, out_w, out_h, n_threads, capacity)
        if not self._handle:
            raise ValueError(f"prefetcher rejected {out_w}x{out_h}")

    def __iter__(self):
        ok = ctypes.c_int()
        for _ in range(self._n):
            out = np.empty(self._shape, np.float32)
            idx = self._lib.kbt_prefetcher_next(
                self._handle, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), ctypes.byref(ok))
            if idx < 0:
                return
            if not ok.value:
                raise IOError(f"failed to decode "
                              f"{os.fsdecode(self._paths[idx])}")
            yield idx, out

    def close(self):
        if self._handle:
            self._lib.kbt_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
