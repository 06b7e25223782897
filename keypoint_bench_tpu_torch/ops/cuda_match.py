"""Kernel D: fused nearest neighbours in both directions on CUDA
(csrc/match.cu).

Replaces keypoint_bench_tpu/ops/pallas_match.py `_kernel` (via
`pallas_nn_dists` / `pallas_mutual_nn`). The plain twin is
ops/matching.py `nn_dists`; `nearest_neighbours` takes it for CPU tensors
only. For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from keypoint_bench_tpu_torch.ops._build import Kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("match", "kbt_nn_dists",
                [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P])


def nearest_neighbours(a: torch.Tensor, b: torch.Tensor):
    """a [..., M, D], b [..., N, D] -> (nn01, d01, nn10, d10), as
    matching.nn_dists computes them."""
    if not a.is_cuda:
        from keypoint_bench_tpu_torch.ops.matching import nn_dists
        return nn_dists(a, b)
    return nn_dists_cuda(a, b)


def nn_dists_cuda(a: torch.Tensor, b: torch.Tensor):
    """Launch kernel D once for every pair of the batch (a memset of the
    row and column keys and two kernel launches, no host sync)."""
    KERNEL.function()   # builds, or raises, before any launch
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("nn_dists_cuda takes CUDA tensors on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"expected float32, got {a.dtype}, {b.dtype}")
    if (a.dim() < 2 or a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2]
            or a.shape[-1] != b.shape[-1] or not a.numel() or not b.numel()):
        raise ValueError(f"expected non-empty [..., M, D] and [..., N, D]; "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    lead = a.shape[:-2]
    m, n, d = a.shape[-2], b.shape[-2], a.shape[-1]
    a3 = a.reshape(-1, m, d).contiguous()
    b3 = b.reshape(-1, n, d).contiguous()
    bsz = a3.shape[0]
    dev = a.device
    nn01 = torch.empty((bsz, m), dtype=torch.int32, device=dev)
    d01 = torch.empty((bsz, m), device=dev)
    nn10 = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    d10 = torch.empty((bsz, n), device=dev)
    keys = torch.empty((bsz, m + n), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(2, a3.data_ptr(), b3.data_ptr(), bsz, m, n, d,
                      nn01.data_ptr(), d01.data_ptr(), nn10.data_ptr(),
                      d10.data_ptr(), keys.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    return (nn01.reshape(*lead, m), d01.reshape(*lead, m),
            nn10.reshape(*lead, n), d10.reshape(*lead, n))
