"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
with nvcc for sm_90a into `keypoint_bench_tpu_torch/_build/` (git-ignored)
and loaded with ctypes. Builds are keyed by a hash of the source and the
flags, and land under their final name by an atomic rename, so concurrent
processes never load a half-written library. Nothing is fetched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Path of the built library for csrc/<name>.cu, building it if needed.
    Each call runs its own nvcc, so threads may build several at once."""
    src, out = _target(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


class Kernel:
    """One exported C entry point of a csrc/ library, loaded lazily.

    `launches` counts the CUDA kernel launches made through `launch`; the
    tests and chip_smoke.py read it to show a path went through the kernel.
    Ranks that run as threads of one process (parallel/mesh.py) share the
    count; a lock keeps their updates, and the first build, whole.
    """

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib_name = lib
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    def function(self):
        """The ctypes function; builds the library at first use and raises
        if the build fails."""
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(build(self.lib_name))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.kbt_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
        return self._fn

    def launch(self, n_launches: int, *args):
        """Call the entry point (it enqueues `n_launches` kernels on the
        given stream) and raise on a non-zero cudaError_t."""
        code = self.function()(*args)
        if code != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {code} "
                               f"({self._err(code).decode()})")
        with self._lock:
            self.launches += n_launches
