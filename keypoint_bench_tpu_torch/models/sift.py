"""Difference-of-Gaussians extrema, SIFT's detection stage (counterpart of
keypoint_bench_tpu/models/sift.py; the reference ships an empty
models/SIFT.py): one octave, a Gaussian ladder sigma_i = 1.6 * 2^(i/3),
DoG differences, the 3x3x3 extremum test, score = |DoG| at extrema.
Configured by `model_params` (n_scales, contrast_th).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keypoint_bench_tpu_torch.models.common import (gray_mean,
                                                     to_float_image)
from keypoint_bench_tpu_torch.models.registry import register


def _gaussian_kernel(sigma: float) -> np.ndarray:
    half = max(int(3 * sigma), 1)
    x = np.arange(-half, half + 1)
    g = np.exp(-x ** 2 / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [B,1,H,W] with reflect padding, rows
    first."""
    g = torch.from_numpy(_gaussian_kernel(sigma)).to(img.device)
    r = len(g) // 2
    x = F.conv2d(F.pad(img, (0, 0, r, r), mode="reflect"), g[None, None, :,
                                                              None])
    return F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"),
                    g[None, None, None, :])


def dog_score(gray: torch.Tensor, n_scales: int = 5, sigma0: float = 1.6,
              contrast_th: float = 0.015) -> torch.Tensor:
    """gray [B,H,W] in [0,1] -> DoG extremum score [B,H,W]."""
    k = 2.0 ** (1.0 / 3.0)
    x = gray[:, None]
    blurs = [_blur(x, sigma0 * k ** i) for i in range(n_scales)]
    dogs = torch.cat([blurs[i + 1] - blurs[i]
                      for i in range(n_scales - 1)], dim=1)   # [B,S,H,W]
    sp_max = F.max_pool2d(dogs, 3, 1, 1)
    sp_min = -F.max_pool2d(-dogs, 3, 1, 1)
    score = torch.zeros_like(gray)
    for i in range(1, dogs.shape[1] - 1):
        up_max = torch.maximum(sp_max[:, i - 1], sp_max[:, i + 1])
        up_min = torch.minimum(sp_min[:, i - 1], sp_min[:, i + 1])
        d = dogs[:, i]
        is_max = (d >= sp_max[:, i]) & (d > up_max) & (d > contrast_th)
        is_min = (d <= sp_min[:, i]) & (d < up_min) & (d < -contrast_th)
        score = torch.maximum(score, torch.where(is_max | is_min, d.abs(),
                                                 torch.zeros_like(d)))
    return score


@register("SIFT")
class SIFT(nn.Module):
    """Configured by `model_params`; holds no tensors."""

    def __init__(self, params: dict):
        super().__init__()
        self.params = dict(params)
        self.n_scales = int(params.get("n_scales", 5))
        self.contrast_th = float(params.get("contrast_th", 0.015))

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (DoG extremum score [B,H,W,1], None)."""
        gray = gray_mean(to_float_image(image))
        return dog_score(gray, self.n_scales, 1.6,
                         self.contrast_th)[..., None], None
