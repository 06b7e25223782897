"""Kernel A: the iterative-NMS fixpoint on CUDA (csrc/nms.cu), and kernel
C: the border mask + per-chunk top-candidate peel (csrc/peel.cu).

Kernel A replaces keypoint_bench_tpu/ops/pallas_nms.py `_nms_kernel`; its
plain twin is ops/detect.py `fast_nms`, and `nms_fixpoint` takes it for CPU
tensors only. Kernel C replaces `_peel_kernel` of the same file; its plain
version is ops/detect.py `peel_topk`, and `peel_candidates` takes it for
CPU tensors only. For a CUDA tensor both launch their kernel or raise.
`fast_nms_topk` is kernel A followed by kernel C (the counterpart of
`fast_nms_topk_pallas`, which also keeps the two apart).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from keypoint_bench_tpu_torch.ops import _build
from keypoint_bench_tpu_torch.ops._build import Kernel
from keypoint_bench_tpu_torch.utils.debug_nans import check_kernel_outputs
from keypoint_bench_tpu_torch.utils import profiling

# the tile's d-pixel halo stays inside its 3x3 tile neighbourhood (d < 32,
# which the changed-tile test needs) and in 48 KB of shared memory
MAX_NMS_DIST = 16
NMS_TILE = 32
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("nms", "kbt_nms_fixpoint",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P])
PEEL_KERNEL = Kernel("peel", "kbt_peel", [_P, _P, _P, _I, _I, _I, _I, _I, _P])
PEEL_CHUNK = 128


def nms_fixpoint(maps: torch.Tensor, nms_dist: int, max_iter: int = 30,
                 min_value: float = 0.0) -> torch.Tensor:
    """NMS fixpoint of [B,H,W] maps, each map stopping on its own; same
    dtype out. Equal bit for bit to detect.fast_nms.

    While a torch profiler runs, kernel A adds its `stats` into the
    counter `kernel_A.stats.B<B>.iter<max_iter>` (`profiling.counter`);
    otherwise it gets none."""
    if not maps.is_cuda:
        from keypoint_bench_tpu_torch.ops.detect import fast_nms
        return fast_nms(maps, nms_dist, max_iter, min_value)
    b = maps.shape[0]
    stats = profiling.counter(f"kernel_A.stats.B{b}.iter{max_iter}",
                              b + 2 * (max_iter + 1), maps.device)
    if stats is None:       # the kernel's plain stand-ins take no stats
        return nms_cuda(maps, nms_dist, max_iter, min_value)
    return nms_cuda(maps, nms_dist, max_iter, min_value, stats=stats)


def nms_cuda(maps: torch.Tensor, nms_dist: int, max_iter: int = 30,
             min_value: float = 0.0,
             stats: torch.Tensor | None = None) -> torch.Tensor:
    """Launch kernel A: one cooperative launch for the batch, no host sync.

    `stats`, if given, is an int32 tensor of B + 2 * (max_iter + 1) zeros
    on the card; the kernel adds the rounds each map ran, then per round
    the tiles whose mask, and the tiles whose suppression, it recomputed,
    summed over the batch (round 0 has no suppression)."""
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
    if stats is not None and (
            stats.device != maps.device or stats.dtype != torch.int32
            or stats.numel() != b + 2 * (max_iter + 1)
            or not stats.is_contiguous()):
        raise ValueError("stats must be a contiguous int32 tensor of "
                         "B + 2 * (max_iter + 1) on the maps' device")
    if nms_dist == 0 or maps.numel() == 0:
        return maps
    # f32 maps are read where they lie and copied into the output by the
    # kernel's first phase; 16-bit maps are widened (value-exact) into the
    # buffer the kernel then updates in place. min_value is rounded to the
    # map dtype as the plain path does.
    if maps.dtype == torch.float32:
        src = maps.contiguous()
        p = torch.empty_like(src)
    else:
        src = p = maps.float().contiguous()
    mv = torch.tensor(min_value, dtype=maps.dtype).float().item()
    dev = maps.device
    words = -(-w // NMS_TILE)
    tiles = b * -(-h // NMS_TILE) * words
    # the local-max mask and the "holds min_value" mask, a bit a pixel
    mask = torch.empty((2, b, h, words), dtype=torch.int32, device=dev)
    # per-map counts of every round, then per tile: count, two stamps
    scratch = torch.zeros((max_iter + 1) * b + 3 * tiles, dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(1, src.data_ptr(), p.data_ptr(), mask.data_ptr(),
                      scratch.data_ptr(),
                      0 if stats is None else stats.data_ptr(), b, h, w,
                      nms_dist, max_iter, mv,
                      torch.cuda.current_stream().cuda_stream)
    check_kernel_outputs(KERNEL.symbol, p)
    return p.to(maps.dtype)


def nms_grid(nms_dist: int) -> tuple[int, int, int, int]:
    """Kernel A's resident grid on the current device at nms_dist: (blocks
    that fit at once, blocks per SM, threads a block, bytes of dynamic
    shared memory a block). A launch takes min(blocks, tiles of the
    batch)."""
    KERNEL.function()
    fn = ctypes.CDLL(_build.build("nms")).kbt_nms_grid
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    code = fn(nms_dist, *map(ctypes.byref, out))
    if code != 0:
        raise RuntimeError(f"kbt_nms_grid failed: CUDA error {code}")
    return tuple(o.value for o in out)


def check_peel_shape(w: int, per_chunk: int):
    """The peel's shape rules (the JAX package's): w a multiple of 128 and
    at most 128 candidates per row."""
    if w % PEEL_CHUNK != 0 or w == 0 or per_chunk < 1 \
            or (w // PEEL_CHUNK) * per_chunk > PEEL_CHUNK:
        raise ValueError(
            f"the fused top-k needs w % 128 == 0 and 1 <= (w // 128) * "
            f"per_chunk <= 128; got w={w}, per_chunk={per_chunk}")


def peel_candidates(nms: torch.Tensor, border: int, per_chunk: int = 8):
    """nms [B,H,W] f32 -> (vals [B,H,(W/128)*per_chunk] f32, idx the same
    shape int32, global columns), as detect.peel_topk computes them."""
    if not nms.is_cuda:
        from keypoint_bench_tpu_torch.ops.detect import peel_topk
        return peel_topk(nms, border, per_chunk)
    return peel_cuda(nms, border, per_chunk)


def peel_cuda(nms: torch.Tensor, border: int, per_chunk: int = 8):
    """Launch kernel C once (one warp per map row)."""
    PEEL_KERNEL.function()   # builds, or raises, before any launch
    if not nms.is_cuda:
        raise ValueError("peel_cuda takes a CUDA tensor")
    if nms.dim() != 3 or nms.dtype != torch.float32:
        raise ValueError(f"expected [B,H,W] float32 maps, got "
                         f"{tuple(nms.shape)} {nms.dtype}")
    b, h, w = nms.shape
    check_peel_shape(w, per_chunk)
    if border < 0:
        raise ValueError(f"border must be >= 0, got {border}")
    nc = (w // PEEL_CHUNK) * per_chunk
    vals = torch.empty((b, h, nc), dtype=torch.float32, device=nms.device)
    idx = torch.empty((b, h, nc), dtype=torch.int32, device=nms.device)
    if b * h == 0:
        return vals, idx
    maps = nms.contiguous()
    if maps.data_ptr() % 16:        # the kernel loads rows as float4
        maps = maps.clone()
    # entering a device context costs a few microseconds a call
    on_dev = (contextlib.nullcontext()
              if nms.device.index == torch.cuda.current_device()
              else torch.cuda.device(nms.device))
    with on_dev:
        PEEL_KERNEL.launch(1, maps.data_ptr(), vals.data_ptr(),
                           idx.data_ptr(), b, h, w, border, per_chunk,
                           torch.cuda.current_stream().cuda_stream)
    check_kernel_outputs(PEEL_KERNEL.symbol, vals)
    return vals, idx


def fast_nms_topk(maps: torch.Tensor, nms_dist: int = 4, max_iter: int = 30,
                  border_dist: int = 8, per_chunk: int = 8,
                  min_value: float = 0.0):
    """NMS fixpoint, then border mask + per-chunk candidate peel, for
    [B,H,W] maps. Returns (nms maps in the maps' dtype WITHOUT the border
    applied, vals [B,H,n_blk*per_chunk] f32, idx int32 global columns).
    Candidates are the border-masked map's per-chunk top values, value
    descending with the lowest column first on ties; the flat (row, blk, j)
    order is index-ordered within equal values of a chunk."""
    if nms_dist == 0:
        raise ValueError("the fused top-k needs nms_dist > 0")
    if maps.dim() != 3:
        raise ValueError(f"expected [B,H,W] maps, got {tuple(maps.shape)}")
    check_peel_shape(maps.shape[-1], per_chunk)
    nms = nms_fixpoint(maps, nms_dist, max_iter, min_value)
    vals, idx = peel_candidates(nms.float(), border_dist, per_chunk)
    return nms, vals, idx
