"""Bilinear sampling with grid_sample(align_corners=True, padding='zeros')
semantics (counterpart of keypoint_bench_tpu/ops/grid_sample.py).

Coordinates are pixel coordinates; normalized points p in [0, 1] sample at
p * (S - 1). Out-of-bounds corners contribute zeros.
"""
from __future__ import annotations

import torch


def _gather_2d(img: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """img [H,W,C]; integer rows/cols [...] -> [..., C], zero off the map."""
    h, w = img.shape[0], img.shape[1]
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    flat = img.reshape(h * w, -1)
    out = flat[rows.clamp(0, h - 1) * w + cols.clamp(0, w - 1)]
    return torch.where(inb[..., None], out, torch.zeros_like(out))


def sample_bilinear_pixels(img: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor) -> torch.Tensor:
    """Sample img [H,W,C] at continuous pixel coords (px, py) [...] ->
    [..., C]."""
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    dx = (px - x0)[..., None]
    dy = (py - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    v00 = _gather_2d(img, y0i, x0i)
    v01 = _gather_2d(img, y0i, x0i + 1)
    v10 = _gather_2d(img, y0i + 1, x0i)
    v11 = _gather_2d(img, y0i + 1, x0i + 1)
    return ((1 - dy) * (1 - dx) * v00 + (1 - dy) * dx * v01
            + dy * (1 - dx) * v10 + dy * dx * v11)


def grid_sample_align_corners(img: torch.Tensor,
                              pts01: torch.Tensor) -> torch.Tensor:
    """Sample img [H,W,C] at pts01 [N,2] of normalized (x, y) -> [N,C]."""
    h, w = img.shape[0], img.shape[1]
    return sample_bilinear_pixels(img, pts01[:, 0] * (w - 1),
                                  pts01[:, 1] * (h - 1))


def sample_at_points(feature_map: torch.Tensor,
                     kpts: torch.Tensor) -> torch.Tensor:
    """Descriptor lookup: feature_map [H,W,C], kpts [K,>=2] normalized
    (x, y) -> [K,C]."""
    return grid_sample_align_corners(feature_map, kpts[:, 0:2])
