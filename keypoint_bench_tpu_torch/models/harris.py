"""Harris corners (counterpart of keypoint_bench_tpu/models/harris.py,
which replaces the reference's cv2.cornerHarris, models/Harris.py:13-21).

cv2.cornerHarris semantics: the input is the reference's uint8 intensity
(sum(RGB) * 255 cast with numpy's wrapping uint8 cast, kept: floor(gray)
% 256); Sobel aperture `ksize` with REFLECT_101 borders and OpenCV's
scale 1 / (2^(ksize-1) * block_size * 255); unnormalized block_size box
sums of the structure tensor; R = det(M) - k * trace(M)^2. Configured by
`model_params` (block_size, ksize, k) instead of weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keypoint_bench_tpu_torch.models.common import to_float_image
from keypoint_bench_tpu_torch.models.registry import register


def _sobel_kernels(ksize: int):
    """OpenCV getDerivKernels for dx / dy, unnormalized (smooth x diff)."""
    if ksize == 3:
        smooth = np.array([1., 2., 1.], np.float32)
        diff = np.array([-1., 0., 1.], np.float32)
    elif ksize == 1:
        smooth = np.array([1.], np.float32)
        diff = np.array([-1., 0., 1.], np.float32)
    else:
        smooth = np.array([1.], np.float32)
        for _ in range(ksize - 1):
            smooth = np.convolve(smooth, [1., 1.])
        diff = np.convolve(np.convolve(np.ones(1), [1., 1.]), [-1., 1.])
        for _ in range(ksize - 3):
            diff = np.convolve(diff, [1., 1.])
        smooth = smooth.astype(np.float32)
        diff = diff.astype(np.float32)
    return np.outer(smooth, diff), np.outer(diff, smooth)


def _reflect101(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    return F.pad(x, (pw, pw, ph, ph), mode="reflect")


def _conv2(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """x [B,1,H,W] correlated with k, REFLECT_101 borders."""
    kh, kw = k.shape
    w = torch.from_numpy(np.asarray(k, np.float32)[None, None]).to(x.device)
    return F.conv2d(_reflect101(x, kh // 2, kw // 2), w)


def harris_response(gray_u8: torch.Tensor, block_size: int = 5,
                    ksize: int = 3, k: float = 0.04) -> torch.Tensor:
    """gray_u8 [B,1,H,W] float values in 0..255 (already uint8-quantized)
    -> the cv2.cornerHarris-compatible response [B,1,H,W]."""
    kx, ky = _sobel_kernels(ksize)
    scale = 1.0 / ((1 << (ksize - 1)) * block_size * 255.0)
    dx = _conv2(gray_u8, kx) * scale
    dy = _conv2(gray_u8, ky) * scale
    r = block_size // 2

    def box(v):
        return F.avg_pool2d(_reflect101(v, r, r), block_size, 1,
                            divisor_override=1)

    a, b, cc = box(dx * dx), box(dx * dy), box(dy * dy)
    return a * cc - b * b - k * (a + cc) ** 2


@register("Harris")
class Harris(nn.Module):
    """Configured by `model_params`; holds no tensors, so it runs on the
    device of the image it is given."""

    def __init__(self, params: dict):
        super().__init__()
        self.params = dict(params)
        self.block_size = int(params.get("block_size", 5))
        self.ksize = int(params.get("ksize", 3))
        self.k = float(params.get("k", 0.04))

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] (float in [0,1] or uint8) -> (score [B,H,W,1],
        None)."""
        gray = to_float_image(image).sum(-1) * 255.0
        gray = torch.floor(gray) % 256.0
        score = harris_response(gray[:, None], self.block_size, self.ksize,
                                self.k)
        return score.permute(0, 2, 3, 1), None
