"""Repeatability over one warped image pair (counterpart of
keypoint_bench_tpu/tasks/repeatability.py; reference
tasks/repeatability.py:54-92 `val_key_points`).

No compaction: invalid rows and columns are pushed to a large constant,
and the reference's diagonal quirk (the first min(M, N) diagonal entries
of the *compacted* distance matrix set to 99999) is replicated through
cumsum ranks over the validity masks.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.utils import profiling

_DIAG = 99999.0
_BIG = 1e9


def _masked_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a[..., :, None, :] - b[..., None, :, :]
    return torch.sqrt((d * d).sum(-1) + 1e-24)


def repeatability_pair(kpts0, valid0, kpts1, valid1,
                       w01_kpts0, w01_kpts01, v01,
                       w10_kpts1, w10_kpts10, v10,
                       scale, th: float = 3.0) -> dict:
    """(num_feat, repeatability, mean_error, gt_num) of a pair as 0-d
    tensors, or of pairs along leading batch dims. w01_* are warp_points
    of kpts0 into frame 1, w10_* of kpts1 into frame 0; `scale` (a number,
    or a tensor of the batch dims) multiplies the normalized distances."""
    with profiling.span("kbt.geometry.repeatability"):
        n0 = valid0.sum(-1)
        n1 = valid1.sum(-1)
        num_feat = torch.minimum(n0, n1)

        pair_ok = v01[..., :, None] & v10[..., None, :]
        dm = (_masked_dist(w01_kpts0, w10_kpts10)
              + _masked_dist(w10_kpts1, w01_kpts01).transpose(-1, -2)) / 2.0
        rank0 = torch.cumsum(v01.int(), -1) - 1
        rank1 = torch.cumsum(v10.int(), -1) - 1
        diag = (rank0[..., :, None] == rank1[..., None, :]) & pair_ok
        dm = torch.where(diag, torch.full_like(dm, _DIAG), dm)
        dm = torch.where(pair_ok, dm, torch.full_like(dm, _BIG))

        row_min = dm.min(dim=-1, keepdim=True).values
        col_min = dm.min(dim=-2, keepdim=True).values
        mutual = (dm == row_min) & (dm == col_min) & pair_ok

        if isinstance(scale, torch.Tensor):
            scale = scale[..., None, None]
        d_scaled = dm * scale
        hit = mutual & (d_scaled <= th)
        gt_num = hit.sum((-2, -1))
        err_sum = torch.where(hit, d_scaled,
                              torch.zeros_like(d_scaled)).sum((-2, -1))
        mean_error = torch.where(gt_num > 0, err_sum / gt_num,
                                 torch.full_like(err_sum, float("nan")))
        rep = torch.where(num_feat > 0, gt_num / torch.clamp_min(num_feat, 1),
                          torch.zeros((), device=dm.device))
        # the reference returns rep = 0 and num_feat = 0 when either covisible
        # set is empty
        either_empty = (v01.sum(-1) == 0) | (v10.sum(-1) == 0)
        rep = torch.where(either_empty, torch.zeros_like(rep), rep)
        num_feat = torch.where(either_empty, torch.zeros_like(num_feat),
                               num_feat)
        return {"num_feat": num_feat, "repeatability": rep,
                "mean_error": mean_error, "gt_num": gt_num}
