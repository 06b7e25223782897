"""Brute-force descriptor matching: squared distances + mutual nearest
neighbours (counterpart of keypoint_bench_tpu/ops/matching.py).

Fixed-K descriptors with validity masks; invalid rows and columns are
pushed to 1e30 so they never match. Every function takes optional leading
batch dimensions.

bf16 descriptors (bf16 mode's sparse path, bench.py's bf16 match) are
matched as the JAX package's `pairwise_sqdist` matches them: f32 norms of
the bf16 values and their products accumulated in f32 (exact products),
here the f32 arithmetic on the upcast values. The upcast is exact, so
kernel D takes them through its f32 path with the validity penalty kept
in f32.
"""
from __future__ import annotations

import math

import torch

from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
from keypoint_bench_tpu_torch.utils import profiling

_BIG = 1e30
_PEN = 1e8  # kernel D: penalty per invalid endpoint, via a sqrt feature


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, D] x [..., N, D] -> [..., M, N] squared euclidean
    distances, |a|^2 + |b|^2 - 2ab in f32 (TF32 off, device.py); bf16
    inputs are upcast, which keeps every product exact."""
    a = a.float()
    b = b.float()
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    ab = a @ b.transpose(-1, -2)
    return torch.clamp_min(a2 + b2.transpose(-1, -2) - 2.0 * ab, 0.0)


def mutual_nn_match(desc0: torch.Tensor, desc1: torch.Tensor,
                    valid0: torch.Tensor, valid1: torch.Tensor,
                    max_distance: float = math.inf):
    """Returns (idx1_of_0 [..., M], match_mask [..., M]): for each row of
    desc0 its nearest row of desc1 (first index on ties); the mask holds
    iff the pair is mutual, both are valid and the distance is strictly
    below max_distance.

    CUDA tensors take `mutual_nn_fused` (kernel D, which never writes the
    [M, N] matrix); CPU tensors the dense form below."""
    if desc0.is_cuda:
        return mutual_nn_fused(desc0, desc1, valid0, valid1, max_distance)
    d2 = pairwise_sqdist(desc0, desc1)
    d2 = torch.where(valid0[..., :, None] & valid1[..., None, :], d2,
                     torch.full_like(d2, _BIG))
    nn01 = torch.argmin(d2, dim=-1)
    nn10 = torch.argmin(d2, dim=-2)
    rows = torch.arange(d2.shape[-2], device=d2.device)
    mutual = nn10.gather(-1, nn01) == rows
    best = d2.gather(-1, nn01[..., None])[..., 0]
    ok = (mutual & valid0 & (best < float(max_distance) ** 2)
          & (best < _BIG))
    return nn01, ok


def nn_dists(a: torch.Tensor, b: torch.Tensor):
    """Plain twin of kernel D (counterpart of pallas_match.pallas_nn_dists):
    a [..., M, D], b [..., N, D] f32 -> (nn01 [..., M] int32, d01 [..., M],
    nn10 [..., N] int32, d10 [..., N]), the row and column minima and
    their first indices of s = |a|^2 + |b|^2 - 2ab (no clamp at 0). Unlike
    the TPU kernel, no zero-padded phantom rows or columns take part."""
    a = a.float()
    b = b.float()
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    s = a2 + b2.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2))
    d01, nn01 = s.min(dim=-1)
    d10, nn10 = s.min(dim=-2)
    return nn01.int(), d01, nn10.int(), d10


def penalized(desc: torch.Tensor, valid: torch.Tensor):
    """desc [..., K, D], valid [..., K] -> (kernel D's input [..., K, D+1]
    f32 with the sqrt(penalty) feature appended, penalty [..., K])."""
    pen = torch.where(valid, 0.0, _PEN).float()
    return torch.cat([desc.float(), torch.sqrt(pen)[..., None]], dim=-1), pen


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(-1, idx.long())


def mutual_nn_fused(desc0: torch.Tensor, desc1: torch.Tensor,
                    valid0: torch.Tensor, valid1: torch.Tensor,
                    max_distance: float = math.inf):
    """Mutual-NN matching through kernel D's semantics (counterpart of
    pallas_match.pallas_mutual_nn): an appended sqrt(_PEN) feature on
    invalid rows and columns keeps them out of every valid minimum; the
    penalties come off the winning distance before the cut-off. CUDA
    tensors launch kernel D, CPU tensors take `nn_dists`; bf16
    descriptors are upcast first (exact)."""
    from keypoint_bench_tpu_torch.ops.cuda_match import nearest_neighbours
    a, pen0 = penalized(desc0, valid0)
    b, pen1 = penalized(desc1, valid1)
    nn01, d01, nn10, _ = nearest_neighbours(a, b)
    rows = torch.arange(desc0.shape[-2], device=desc0.device)
    mutual = _gather(nn10, nn01) == rows
    true_d = d01 - pen0 - _gather(pen1, nn01)
    ok = (mutual & valid0 & _gather(valid1, nn01)
          & (true_d < float(max_distance) ** 2))
    return nn01.long(), ok


def take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[..., idx, :]: values [..., N, D], idx [..., M] -> [..., M, D]."""
    return values.gather(-2, idx[..., None].expand(
        *idx.shape, values.shape[-1]))


def brute_force_match(kpts0, valid0, kpts1, valid1, desc_map0, desc_map1,
                      max_distance: float = 5.0):
    """Reference brute-force matcher on dense descriptor maps [H,W,D]:
    (kpts0 [K,3], matched kpts1 rows [K,3], match mask [K])."""
    with profiling.span("kbt.ops.describe"):
        desc0 = sample_at_points(desc_map0, kpts0)
        desc1 = sample_at_points(desc_map1, kpts1)
    nn01, ok = mutual_nn_match(desc0, desc1, valid0, valid1, max_distance)
    return kpts0, take_rows(kpts1, nn01), ok
