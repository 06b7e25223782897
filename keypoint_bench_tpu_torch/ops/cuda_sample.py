"""Kernel B: the fused multi-branch sparse-descriptor sampler on CUDA
(csrc/sample.cu).

Replaces keypoint_bench_tpu/ops/pallas_sample.py `_kernel` and, for the
y-ordered API, `_sorted_kernel`. The plain twin is
ops/sparse_desc.py `sample_branches`; `fused_samples_batch` takes it for
CPU tensors only. For CUDA tensors it launches the kernel or raises. The
kernel's taps read rows lo and lo+1 of a branch with lo <= n-2, so it
needs branches of at least 2 x 2; it also serves the 2- and 3-row maps
for which the reference leaves its 4-row TPU window and resizes densely.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from keypoint_bench_tpu_torch.ops._build import Kernel

MAX_BRANCHES = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("sample", "kbt_sample",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P])


def fused_samples_batch(feats_b, px_b: torch.Tensor, py_b: torch.Tensor,
                        h: int, w: int) -> torch.Tensor:
    """feats_b: tuple of channel-major [B,C,H_i,W_i] (branch 0 at h x w);
    px_b/py_b [B,K] f32 pixel coordinates -> [B, sum C_i, K] f32."""
    if not px_b.is_cuda:
        from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
        return sample_branches(feats_b, px_b, py_b, h, w)
    return sample_cuda(feats_b, px_b, py_b, h, w)


def sample_cuda(feats_b, px_b: torch.Tensor, py_b: torch.Tensor,
                h: int, w: int) -> torch.Tensor:
    """Launch kernel B once for the whole batch."""
    fn = KERNEL.function()
    nb = len(feats_b)
    if not 1 <= nb <= MAX_BRANCHES:
        raise ValueError(f"1..{MAX_BRANCHES} branches, got {nb}")
    dev = px_b.device
    for t in (*feats_b, px_b, py_b):
        if not t.is_cuda or t.device != dev:
            raise ValueError("all inputs must be CUDA tensors on one device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("inputs must be contiguous float32")
    if px_b.dim() != 2 or py_b.shape != px_b.shape:
        raise ValueError(f"px/py must be [B,K]; got {tuple(px_b.shape)}, "
                         f"{tuple(py_b.shape)}")
    b, k = px_b.shape
    c = feats_b[0].shape[1]
    for f in feats_b:
        if f.dim() != 4 or f.shape[0] != b or f.shape[1] != c:
            raise ValueError(f"branch features must be [B={b}, C={c}, h, w]; "
                             f"got {tuple(f.shape)}")
    if tuple(feats_b[0].shape[-2:]) != (h, w) or min(
            min(f.shape[-2:]) for f in feats_b) < 2:
        raise ValueError("branch 0 must be h x w and every branch >= 2 x 2")
    out = torch.empty((b, nb * c, k), dtype=torch.float32, device=dev)
    if k == 0 or b == 0:
        return out
    hs = [int(f.shape[2]) for f in feats_b]
    ws = [int(f.shape[3]) for f in feats_b]
    # the upsample ratio rounded to f32, as the plain taps compute it
    sy = [float(np.float32((hi - 1.0) / (h - 1.0))) for hi in hs]
    sx = [float(np.float32((wi - 1.0) / (w - 1.0))) for wi in ws]
    ptrs = (ctypes.c_void_p * nb)(*[f.data_ptr() for f in feats_b])
    with torch.cuda.device(dev):
        KERNEL.launch(1, ptrs, (ctypes.c_int * nb)(*hs),
                      (ctypes.c_int * nb)(*ws), (ctypes.c_float * nb)(*sy),
                      (ctypes.c_float * nb)(*sx), nb, c, h, w,
                      px_b.data_ptr(), py_b.data_ptr(), out.data_ptr(), b, k,
                      torch.cuda.current_stream().cuda_stream)
    return out
