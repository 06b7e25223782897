"""FAST-9/16 corner score, ORB's detection stage (counterpart of
keypoint_bench_tpu/models/orb.py; the reference ships an empty
models/ORB.py). A pixel is a corner iff >= 9 contiguous pixels of the
radius-3 Bresenham circle are all brighter than I(p) + t or all darker
than I(p) - t; the score is the summed threshold excess of the qualifying
side. Configured by `model_params` (threshold).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from keypoint_bench_tpu_torch.models.common import (gray_mean,
                                                     to_float_image)
from keypoint_bench_tpu_torch.models.registry import register

# radius-3 Bresenham circle offsets (row, col), clockwise from 12 o'clock
_CIRCLE = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
           (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3),
           (-2, -2), (-3, -1)]


def fast_score(gray: torch.Tensor, threshold: float = 10.0,
               arc: int = 9) -> torch.Tensor:
    """gray [B,H,W] (0..255 scale) -> FAST corner score [B,H,W]."""
    h, w = gray.shape[-2:]
    pad = F.pad(gray[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    ring = torch.stack([pad[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in _CIRCLE])            # [16,B,H,W]
    d = ring - gray[None]

    def has_run(m):
        mm = torch.cat([m, m[:arc - 1]])                   # wrap
        return torch.stack([mm[s:s + arc].all(0) for s in range(16)]).any(0)

    sb = torch.clamp_min(d - threshold, 0.0).sum(0)
    sd = torch.clamp_min(-d - threshold, 0.0).sum(0)
    zero = torch.zeros_like(sb)
    return (torch.where(has_run(d > threshold), sb, zero)
            + torch.where(has_run(d < -threshold), sd, zero))


@register("ORB")
class ORB(nn.Module):
    """Configured by `model_params`; holds no tensors."""

    def __init__(self, params: dict):
        super().__init__()
        self.params = dict(params)
        self.threshold = float(params.get("threshold", 10.0))

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (FAST score [B,H,W,1], None)."""
        gray = gray_mean(to_float_image(image), 255.0)
        return fast_score(gray, self.threshold)[..., None], None
