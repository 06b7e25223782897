"""Masked fixed-K homography warps (counterpart of the homography parts of
keypoint_bench_tpu/geometry/warp.py).

Pixels are p01 * (w-1, h-1); a warped point is valid iff it lands inside
[0, w-1] x [0, h-1]. The SE3-with-depth warp is still to port (ROADMAP).
"""
from __future__ import annotations

import torch


def warp_homography(kpts01: torch.Tensor, valid: torch.Tensor,
                    H: torch.Tensor, width, height):
    """kpts01 [..., K, >=2] normalized (x, y); H [..., 3, 3]; width/height
    of the image H is expressed in. Returns (kpts0 [..., K, 2], kpts01w
    [..., K, 2], valid [..., K]), all normalized by (w-1, h-1)."""
    H = torch.as_tensor(H, dtype=torch.float32, device=kpts01.device)
    scale = torch.tensor([float(width) - 1.0, float(height) - 1.0],
                         dtype=torch.float32, device=kpts01.device)
    p = kpts01[..., 0:2] * scale
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    q = ph @ H.transpose(-1, -2)
    qz = q[..., 2:3]
    safe = torch.where(qz.abs() > 1e-12, qz, torch.full_like(qz, 1e-12))
    q = q[..., 0:2] / safe
    inb = ((q[..., 0] >= 0) & (q[..., 0] <= scale[0])
           & (q[..., 1] >= 0) & (q[..., 1] <= scale[1]))
    return p / scale, q / scale, valid & inb


def warp_points(kpts: torch.Tensor, valid: torch.Tensor, warp_params: dict):
    """Mode dispatch; only mode 'homo' is ported so far."""
    mode = warp_params["mode"]
    if mode == "homo":
        return warp_homography(kpts, valid, warp_params["homography_matrix"],
                               warp_params["width"], warp_params["height"])
    if mode == "se3":
        raise NotImplementedError(
            "the se3 warp is not ported yet (ROADMAP.md, Queue 1 item 7)")
    raise ValueError(f"unknown warp mode {mode!r}")
