"""Key.Net (counterpart of keypoint_bench_tpu/models/keynet.py; reference
models/KeyNet.py:99-132): channel-sum input; 3 pyramid levels (5x5
Gaussian blur, then a half-pixel bilinear resize by 1/1.2); per level a
handcrafted 10-channel Sobel cascade feeding 3 learnable 5x5 conv + BN +
ReLU blocks; each level's features resized back to the input size,
concatenated and reduced by a 5x5 conv + ReLU. Detector only: desc is
None.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


def _handcrafted(x: torch.Tensor) -> torch.Tensor:
    dx, dy = c.sobel_gradients(x)
    dxx, dxy = c.sobel_gradients(dx)
    _, dyy = c.sobel_gradients(dy)
    return torch.cat([dx, dy, dx ** 2, dy ** 2, dx * dy, dxy, dxy ** 2, dxx,
                      dyy, dxx * dyy], dim=1)


def _learnable(x: torch.Tensor, p: dict) -> torch.Tensor:
    for i in (0, 1, 2):
        pre = f"feature_extractor.lb_block.conv{i}"
        x = c.conv_bn(x, p[f"{pre}.0.weight"], p.get(f"{pre}.0.bias"),
                      c.bn_params(p, f"{pre}.1"), 1, 2, relu=True)
    return x


@register("KeyNet")
class KeyNet(c.ParamModule):
    num_levels = 3

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (score [B,H,W,1], None)."""
        p = self.params
        x = c.to_float_image(image).sum(-1)[:, None].contiguous()
        h, w = x.shape[-2], x.shape[-1]
        feats, cur = [], x
        for i in range(self.num_levels):
            if i > 0:
                cur = c.resize_bilinear_half_pixel(
                    c.gaussian_pyr_blur(cur), int(cur.shape[-2] // 1.2),
                    int(cur.shape[-1] // 1.2))
            f = _learnable(_handcrafted(cur), p)
            if i > 0:
                f = c.resize_bilinear_half_pixel(f, h, w)
            feats.append(f)
        score = c.relu(c.conv2d(torch.cat(feats, dim=1),
                                p["last_conv.0.weight"],
                                p.get("last_conv.0.bias"), 1, 2))
        return score.permute(0, 2, 3, 1), None
