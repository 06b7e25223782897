"""Mean Homography Accuracy over image pairs (counterpart of
keypoint_bench_tpu/tasks/mha.py; reference tasks/MHA.py:11-72).

RANSAC homography on the matched keypoints, the four image corners
transferred by the estimated and the true H (the reference's corner list
mixes h and w by its own convention, replicated), scaled by
(resize/h, resize/w); a hit is a mean corner distance <= th.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.geometry.ransac import (
    ransac_homography, ransac_homography_from_samples)


def mha_pair(m_pts0, m_pts1, match_mask, H_gt, width, height, resize_h,
             resize_w, generator: torch.Generator | None = None,
             thresholds=(3.0, 5.0, 7.0), n_hyp: int = 512,
             sample_idx: torch.Tensor | None = None) -> torch.Tensor:
    """m_pts0/1 [..., K, >=2] matched keypoints normalized to [0, 1];
    match_mask [..., K]; H_gt [..., 3, 3]; width/height the original image
    size; resize_* the network input size. RANSAC draws its minimal samples
    from `generator`, or takes them from `sample_idx` [..., n_hyp, 4].
    Returns [..., len(thresholds)] hits as f32."""
    dev = m_pts0.device
    f32 = torch.float32
    w = torch.as_tensor(width, dtype=f32, device=dev)
    h = torch.as_tensor(height, dtype=f32, device=dev)
    scale = torch.stack([w - 1.0, h - 1.0])
    p0 = m_pts0[..., 0:2] * scale
    p1 = m_pts1[..., 0:2] * scale
    if sample_idx is None:
        H_est, _, ok = ransac_homography(p0, p1, match_mask, generator,
                                         n_hyp=n_hyp, thresh=3.0)
    else:
        H_est, _, ok = ransac_homography_from_samples(p0, p1, match_mask,
                                                      sample_idx, thresh=3.0)
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    corners = torch.stack([torch.stack([zero, zero, one]),
                           torch.stack([h - 1.0, zero, one]),
                           torch.stack([zero, w - 1.0, one]),
                           torch.stack([h - 1.0, w - 1.0, one])])

    def transfer(H):
        q = corners @ H.transpose(-1, -2)
        return q[..., 0:2] / q[..., 2:3]

    H_gt = torch.as_tensor(H_gt, dtype=f32, device=dev)
    rs = torch.stack([resize_h / h, resize_w / w])
    d = torch.linalg.vector_norm((transfer(H_gt) - transfer(H_est)) * rs,
                                 dim=-1)
    ths = torch.as_tensor(thresholds, dtype=f32, device=dev)
    hits = (d.mean(-1)[..., None] <= ths).float()
    return torch.where(ok[..., None], hits, torch.zeros_like(hits))
