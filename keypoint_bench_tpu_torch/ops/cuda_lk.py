"""Kernel F: one Lucas-Kanade pyramid level on CUDA (csrc/lk.cu).

Replaces keypoint_bench_tpu/ops/pallas_lk.py `_lk_kernel` (via
`lk_level_pallas`). The plain version is ops/lk.py `_lk_level`; `lk_level`
takes it for CPU tensors only. For CUDA tensors it launches the kernel or
raises: shapes the kernel does not serve do not drop to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from keypoint_bench_tpu_torch.ops._build import Kernel
from keypoint_bench_tpu_torch.utils.debug_nans import check_kernel_outputs

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("lk", "kbt_lk_level",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])
# a block's window, gradient corners and template live in shared memory;
# above the default 48 KB the kernel asks for it, up to the card's 227 KB
MAX_SMEM_BYTES = 227 * 1024


def smem_bytes(win: int, c: int) -> int:
    """Dynamic shared memory of one block (csrc/lk.cu lk_smem_bytes)."""
    s, g = win + 3, win + 1
    return 4 * (s * s * c + 2 * g * g * c + win * win * c)


def block_threads(win: int, c: int) -> int:
    """Threads of a point's block: a lane per element (x, channel) of a
    patch row, a warp per band of rows."""
    row = win * c
    return 32 if row <= 32 else 64


def lk_level(imgs1: torch.Tensor, imgs2: torch.Tensor, pts1: torch.Tensor,
             pts2: torch.Tensor, win: int, iterations: int) -> torch.Tensor:
    """One LK level for a batch: imgs [B,H,W,C], pts [B,N,2] in this
    level's pixels -> tracked [B,N,2], as lk._lk_level computes it."""
    if not imgs1.is_cuda:
        from keypoint_bench_tpu_torch.ops.lk import _lk_level
        return _lk_level(imgs1, imgs2, pts1, pts2, win, iterations)
    return lk_level_cuda(imgs1, imgs2, pts1, pts2, win, iterations)


def lk_level_cuda(imgs1: torch.Tensor, imgs2: torch.Tensor,
                  pts1: torch.Tensor, pts2: torch.Tensor, win: int,
                  iterations: int,
                  moves: torch.Tensor | None = None) -> torch.Tensor:
    """Launch kernel F once (one block per point, no host sync). `moves`,
    one int32 on the card, gains the number of iterations, over all
    points, that loaded a window (a measurement; the result is the same
    with and without it)."""
    KERNEL.function()   # builds, or raises, before any launch
    tensors = (imgs1, imgs2, pts1, pts2)
    if not all(t.is_cuda and t.device == imgs1.device for t in tensors):
        raise ValueError("lk_level_cuda takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"expected float32, got "
                         f"{[str(t.dtype) for t in tensors]}")
    if imgs1.dim() != 4 or imgs1.shape != imgs2.shape:
        raise ValueError(f"expected two [B,H,W,C] image batches, got "
                         f"{tuple(imgs1.shape)}, {tuple(imgs2.shape)}")
    b, h, w, c = imgs1.shape
    if (pts1.dim() != 3 or pts1.shape != pts2.shape or pts1.shape[0] != b
            or pts1.shape[2] != 2):
        raise ValueError(f"expected [B,N,2] points for B={b}, got "
                         f"{tuple(pts1.shape)}, {tuple(pts2.shape)}")
    if win < 3 or win % 2 == 0 or iterations < 0:
        raise ValueError(f"win must be odd and >= 3, iterations >= 0; got "
                         f"{win}, {iterations}")
    if smem_bytes(win, c) > MAX_SMEM_BYTES:
        raise ValueError(f"win={win} with C={c} needs {smem_bytes(win, c)} "
                         f"bytes of shared memory per block, above "
                         f"{MAX_SMEM_BYTES}")
    if moves is not None and (moves.dtype != torch.int32
                              or moves.device != imgs1.device
                              or moves.numel() != 1):
        raise ValueError("moves must be one int32 on the images' device")
    n = pts1.shape[1]
    out = torch.empty((b, n, 2), dtype=torch.float32, device=imgs1.device)
    if b * n == 0:
        return out
    threads = block_threads(win, c)
    i1, i2, p1, p2 = (t.contiguous() for t in tensors)
    with torch.cuda.device(imgs1.device):
        KERNEL.launch(1, i1.data_ptr(), i2.data_ptr(), p1.data_ptr(),
                      p2.data_ptr(), out.data_ptr(),
                      None if moves is None else moves.data_ptr(), b, n, h,
                      w, c, win,
                      iterations, threads,
                      torch.cuda.current_stream().cuda_stream)
    check_kernel_outputs(KERNEL.symbol, out)
    return out
