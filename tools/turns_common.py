"""What the *_turns.py tools share: building another revision of a kernel
source beside this one, the card's name and power limit, and a call's
device time from torch.profiler.

The tools run as scripts (`python tools/<name>_turns.py ...`), so this
module is imported from their own directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(src: str, stem: str, entry: str, argtypes,
          flags=()) -> ctypes.CDLL:
    """`src` built with the port's nvcc flags (and `flags`) into a library
    named by the source's and flags' hash, `entry` typed with `argtypes`,
    returning int."""
    from keypoint_bench_tpu_torch.ops import _build
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"lib{stem}_turns_{tag[:16]}.so")
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                        out, src], check=True)
    lib = ctypes.CDLL(out)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(call, calls=10, tries=3):
    """(device ms of a call, [(kernel, device ms a call)]) from
    torch.profiler over `calls` calls of call(). The profiler now and then
    records no device activity for a window: it profiles again, up to
    `tries` times, and gives (None, []) if it never does."""
    import chip_smoke as cs
    for _ in range(tries):
        busy, _, kernels = cs.profile_step(
            lambda: [call() for _ in range(calls)])
        if busy > 0:
            return busy / calls, [(n, t / calls) for n, t in kernels]
    return None, []
