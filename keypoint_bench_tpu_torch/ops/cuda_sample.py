"""Kernel B: the fused multi-branch sparse-descriptor sampler on CUDA
(csrc/sample.cu).

Replaces keypoint_bench_tpu/ops/pallas_sample.py `_kernel` and, for the
y-ordered API, `_sorted_kernel`. The plain twin is
ops/sparse_desc.py `sample_branches`; `fused_samples_batch` takes it for
CPU tensors only. For CUDA tensors it launches the kernel or raises. The
kernel's taps read rows lo and lo+1 of a branch with lo <= n-2, so it
needs branches of at least 2 x 2; it also serves the 2- and 3-row maps
for which the reference leaves its 4-row TPU window and resizes densely.
It collapses a branch's composite window to rows la..la+2, which holds
when every branch i >= 1 is no finer than branch 0 (`launch_args` checks
it per shape with the kernel's own f32 arithmetic).

The per-shape work of a launch (the shape checks, the f32 ratios, the
ctypes arrays) is done once per shape and cached, so back-to-back calls
cost little host time beside the kernel.

bf16 branch features (bf16 mode) launch the kernel's bf16 instantiation,
`KERNEL_BF16`, which rounds the column tap weights to bf16 as the TPU
kernel does; every branch of a call has one dtype, and the output is f32.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from keypoint_bench_tpu_torch.ops._build import Kernel
from keypoint_bench_tpu_torch.utils.debug_nans import check_kernel_outputs

MAX_BRANCHES = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P]
KERNEL = Kernel("sample", "kbt_sample", _ARGS)
KERNEL_BF16 = Kernel("sample", "kbt_sample_bf16", _ARGS)
_KERNELS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}


def fused_samples_batch(feats_b, px_b: torch.Tensor, py_b: torch.Tensor,
                        h: int, w: int) -> torch.Tensor:
    """feats_b: tuple of channel-major [B,C,H_i,W_i] f32 or bf16 (branch 0
    at h x w); px_b/py_b [B,K] f32 pixel coordinates -> [B, sum C_i, K]
    f32."""
    if not px_b.is_cuda:
        from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
        return sample_branches(feats_b, px_b, py_b, h, w)
    return sample_cuda(feats_b, px_b, py_b, h, w)


def upsample_ratio(n_lo: int, n_hi: int) -> np.float32:
    """(n_lo - 1) / (n_hi - 1) rounded to f32, as the plain taps compute it."""
    return np.float32((n_lo - 1.0) / (n_hi - 1.0))


def window_fits(n_hi: int, n_lo: int) -> bool:
    """True if, along an axis of n_hi full-resolution rows, the composite
    taps of every row y0 read low-resolution rows lb == la or la + 1 (so
    rows la..la+2 hold them), in the kernel's f32 arithmetic. Rows outside
    0..n_hi-2 clip to rows that already hold it."""
    s = upsample_ratio(n_lo, n_hi)
    y = np.arange(n_hi - 1, dtype=np.float32)
    la = np.clip(np.floor(y * s), 0, n_lo - 2)
    lb = np.clip(np.floor((y + np.float32(1)) * s), 0, n_lo - 2)
    return bool((lb - la <= 1).all())


@functools.lru_cache(maxsize=64)
def launch_args(shapes, pshape, qshape, h: int, w: int):
    """Checked launch arguments for branch shapes `shapes` ([B,C,H_i,W_i]
    each), px / py shapes and the full resolution h x w, cached per shape:
    (b, k, c, ctypes arrays of heights, widths, row and column ratios).
    Raises ValueError for shapes the kernel does not take."""
    nb = len(shapes)
    if len(pshape) != 2 or qshape != pshape:
        raise ValueError(f"px/py must be [B,K]; got {tuple(pshape)}, "
                         f"{tuple(qshape)}")
    b, k = pshape
    c = shapes[0][1]
    for s in shapes:
        if len(s) != 4 or s[0] != b or s[1] != c:
            raise ValueError(f"branch features must be [B={b}, C={c}, h, w]; "
                             f"got {tuple(s)}")
    if tuple(shapes[0][-2:]) != (h, w) or min(
            min(s[-2:]) for s in shapes) < 2:
        raise ValueError("branch 0 must be h x w and every branch >= 2 x 2")
    hs = [int(s[2]) for s in shapes]
    ws = [int(s[3]) for s in shapes]
    if not all(window_fits(h, hi) and window_fits(w, wi)
               for hi, wi in zip(hs[1:], ws[1:])):
        raise ValueError(f"branches after the first must be no finer than "
                         f"branch 0 ({h} x {w}); got {list(zip(hs, ws))}")
    sy = [float(upsample_ratio(hi, h)) for hi in hs]
    sx = [float(upsample_ratio(wi, w)) for wi in ws]
    return (b, k, c, (ctypes.c_int * nb)(*hs), (ctypes.c_int * nb)(*ws),
            (ctypes.c_float * nb)(*sy), (ctypes.c_float * nb)(*sx))


def sample_cuda(feats_b, px_b: torch.Tensor, py_b: torch.Tensor,
                h: int, w: int) -> torch.Tensor:
    """Launch kernel B (its f32 or bf16 instantiation, by the branches'
    dtype) once for the whole batch."""
    kernel = _KERNELS.get(feats_b[0].dtype if feats_b else None)
    if kernel is None:
        raise ValueError("branch features must be float32 or bfloat16")
    kernel.function()   # builds, or raises, before any check
    nb = len(feats_b)
    if not 1 <= nb <= MAX_BRANCHES:
        raise ValueError(f"1..{MAX_BRANCHES} branches, got {nb}")
    dev = px_b.device
    for t in (*feats_b, px_b, py_b):
        if not t.is_cuda or t.device != dev:
            raise ValueError("all inputs must be CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if any(f.dtype != feats_b[0].dtype for f in feats_b) or (
            px_b.dtype != torch.float32 or py_b.dtype != torch.float32):
        raise ValueError("branch features of one dtype and float32 "
                         "coordinates expected")
    b, k, c, hs, ws, sy, sx = launch_args(
        tuple(f.shape for f in feats_b), px_b.shape, py_b.shape, h, w)
    out = torch.empty((b, nb * c, k), dtype=torch.float32, device=dev)
    if k == 0 or b == 0:
        return out
    ptrs = (ctypes.c_void_p * nb)(*[f.data_ptr() for f in feats_b])
    # entering a device context costs a few microseconds a call
    on_dev = (contextlib.nullcontext()
              if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev))
    with on_dev:
        kernel.launch(1, ptrs, hs, ws, sy, sx, nb, c, h, w, px_b.data_ptr(),
                      py_b.data_ptr(), out.data_ptr(), b, k,
                      torch.cuda.current_stream().cuda_stream)
    check_kernel_outputs(kernel.symbol, out)
    return out
