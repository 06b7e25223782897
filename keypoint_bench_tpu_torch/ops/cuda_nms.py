"""Kernel A: the iterative-NMS fixpoint on CUDA (csrc/nms.cu).

Replaces keypoint_bench_tpu/ops/pallas_nms.py `_nms_kernel`. The plain
twin is ops/detect.py `fast_nms`; `nms_fixpoint` takes it for CPU tensors
only. For a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from keypoint_bench_tpu_torch.ops._build import Kernel

# the tile's halo lives in shared memory: d <= 16 keeps both launches under
# 48 KB of dynamic shared memory per block
MAX_NMS_DIST = 16
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("nms", "kbt_nms_fixpoint",
                [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P])


def nms_fixpoint(maps: torch.Tensor, nms_dist: int, max_iter: int = 30,
                 min_value: float = 0.0) -> torch.Tensor:
    """NMS fixpoint of [B,H,W] maps, each map stopping on its own; same
    dtype out. Equal bit for bit to detect.fast_nms."""
    if not maps.is_cuda:
        from keypoint_bench_tpu_torch.ops.detect import fast_nms
        return fast_nms(maps, nms_dist, max_iter, min_value)
    return nms_cuda(maps, nms_dist, max_iter, min_value)


def nms_cuda(maps: torch.Tensor, nms_dist: int, max_iter: int = 30,
             min_value: float = 0.0) -> torch.Tensor:
    """Launch kernel A (1 + 2*max_iter launches, no host sync)."""
    fn = KERNEL.function()
    if not maps.is_cuda:
        raise ValueError("nms_cuda takes a CUDA tensor")
    if maps.dim() != 3:
        raise ValueError(f"expected [B,H,W] maps, got {tuple(maps.shape)}")
    if maps.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"unsupported dtype {maps.dtype}")
    if not 0 <= nms_dist <= MAX_NMS_DIST or max_iter < 0:
        raise ValueError(f"nms_dist must lie in [0, {MAX_NMS_DIST}] and "
                         f"max_iter >= 0; got {nms_dist}, {max_iter}")
    b, h, w = maps.shape
    if nms_dist == 0 or maps.numel() == 0:
        return maps
    # the kernel updates its own f32 copy in place (value-exact for 16-bit
    # maps); min_value is rounded to the map dtype as the plain path does
    p = maps.to(torch.float32, copy=True).contiguous()
    mv = torch.tensor(min_value, dtype=maps.dtype).float().item()
    dev = maps.device
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    counts = torch.zeros((max_iter + 1) * b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(1 + 2 * max_iter, p.data_ptr(), mask.data_ptr(),
                      counts.data_ptr(), done.data_ptr(), b, h, w, nms_dist,
                      max_iter, mv, torch.cuda.current_stream().cuda_stream)
    return p.to(maps.dtype)
