"""Fundamental-matrix epipolar error on sequence datasets (counterpart of
keypoint_bench_tpu/tasks/fundamental.py; reference tasks/
FundamentalMatrix.py:89-161).

Keypoints of the previous frame tracked or matched into the current one;
the error against the ground-truth F (x1^T F x0 = 0) is
    error_i = |x1_i^T F x0_i| / max(||(F x0_i)[:2]||, 1e-6),
`fundamental_radio` the share of valid entries below `th`, and
`fundamental_num` their count. Also the RANSAC inlier-ratio variant
(FundamentalMatrix.py:12-86). Every function takes leading batch
dimensions.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.geometry.ransac import ransac_fundamental


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def epipolar_errors(kps0_px, kps1_px, mask, F):
    """kps0/1 [..., K, 2] pixel coordinates, F [..., 3, 3]. Returns
    (errors [..., K], mask)."""
    x0 = _homogeneous(kps0_px)
    x1 = _homogeneous(kps1_px)
    lines = x0 @ F.transpose(-1, -2)                    # [..., K, 3]
    num = (x1 * lines).sum(-1).abs()
    den = torch.linalg.vector_norm(lines[..., 0:2], dim=-1).clamp_min(1e-6)
    return num / den, mask


def fundamental_metrics(kps0_px, kps1_px, mask, F, th: float = 3.0):
    """dict(fundamental_error: the mean over valid entries,
    fundamental_radio, fundamental_num), each [...]; the mean divides by
    max(number of valid entries, 1)."""
    err, mask = epipolar_errors(kps0_px, kps1_px, mask, F)
    n = mask.sum(-1).clamp_min(1)
    mean_err = torch.where(mask, err, torch.zeros_like(err)).sum(-1) / n
    hits = (mask & (err < th)).sum(-1)
    return {"fundamental_error": mean_err,
            "fundamental_radio": hits / n,
            "fundamental_num": hits}


def fundamental_ransac_ratio(kps0_px, kps1_px, mask,
                             generator: torch.Generator, n_hyp: int = 512):
    """RANSAC inlier-ratio variant: F estimated from the matches, the
    share of valid entries that are its inliers (0 when RANSAC fails)."""
    _, inl, ok = ransac_fundamental(kps0_px, kps1_px, mask, generator,
                                    n_hyp=n_hyp)
    total = mask.sum(-1).clamp_min(1)
    n_inl = inl.sum(-1)
    ratio = torch.where(ok, n_inl / total, torch.zeros_like(n_inl / total))
    return {"fundamental_radio": ratio, "fundamental_num": n_inl}
