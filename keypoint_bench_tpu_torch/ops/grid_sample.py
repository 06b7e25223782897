"""Bilinear sampling with grid_sample(align_corners=True, padding='zeros')
semantics (counterpart of keypoint_bench_tpu/ops/grid_sample.py).

Coordinates are pixel coordinates; normalized points p in [0, 1] sample at
p * (S - 1). Out-of-bounds corners contribute zeros.
"""
from __future__ import annotations

import torch


def sample_bilinear_pixels(img: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor) -> torch.Tensor:
    """Sample img [..., H, W, C] at continuous pixel coords (px, py) ->
    [..., K, C]. px/py share img's leading dims before their own: one
    [H, W, C] image takes coordinates of any shape [...] -> [..., C]."""
    h, w, c = img.shape[-3:]
    flat = img.reshape(-1, h * w, c)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    dx = (px - x0)[..., None]
    dy = (py - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def tap(rows, cols):
        """The [..., C] values at integer (rows, cols), zero off the map."""
        inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
        idx = (rows.clamp(0, h - 1) * w + cols.clamp(0, w - 1)).reshape(
            flat.shape[0], -1)
        out = flat.gather(1, idx[..., None].expand(*idx.shape, c))
        out = out.reshape(*rows.shape, c)
        return torch.where(inb[..., None], out, torch.zeros_like(out))

    return ((1 - dy) * (1 - dx) * tap(y0i, x0i)
            + (1 - dy) * dx * tap(y0i, x0i + 1)
            + dy * (1 - dx) * tap(y0i + 1, x0i)
            + dy * dx * tap(y0i + 1, x0i + 1))


def grid_sample_align_corners(img: torch.Tensor,
                              pts01: torch.Tensor) -> torch.Tensor:
    """Sample img [..., H, W, C] at pts01 [..., N, 2] of (x, y) in [0, 1]
    -> [..., N, C]: torch grid_sample(align_corners=True) on the grid
    (p - 0.5) * 2, i.e. at pixel coordinate p * (S - 1)."""
    h, w = img.shape[-3], img.shape[-2]
    return sample_bilinear_pixels(img, pts01[..., 0] * (w - 1),
                                  pts01[..., 1] * (h - 1))


def sample_at_points(feature_map: torch.Tensor,
                     kpts: torch.Tensor) -> torch.Tensor:
    """Descriptor lookup (reference utils/matcher.py:221-226):
    feature_map [..., H, W, C], kpts [..., K, >=2] with normalized (x, y)
    in columns 0:2 -> [..., K, C]."""
    return grid_sample_align_corners(feature_map, kpts[..., 0:2])
