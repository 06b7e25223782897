"""DISK (counterpart of keypoint_bench_tpu/models/disk.py; reference
models/disk.py:233-313): a thin U-Net with PReLU gates and InstanceNorm
(DEFAULT_SETUP: padding, bias), down [16,32,64,64,64] behind 2x2 average
pools, up [64,64,64,129] through half-pixel bilinear x2 upsampling and
skip concatenation; desc = the L2-normalized first 128 channels, score =
the sigmoid of the last.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


def _conv_unit(x: torch.Tensor, p: dict, prefix: str, first: bool = False):
    """DISK `Conv` (disk.py:79-99): InstanceNorm -> PReLU -> conv5x5 (pad
    2); the very first block skips the norm and the gate."""
    if not first:
        x = c.prelu(c.instance_norm(x), p[f"{prefix}.1.weight"])
    return c.conv2d(x, p[f"{prefix}.3.weight"], p.get(f"{prefix}.3.bias"),
                    1, 2)


@register("DISK")
class DISK(c.ParamModule):

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] (H, W multiples of 16) -> (score [B,H,W,1],
        desc [B,H,W,128])."""
        p = self.params
        x = c.nchw_image(image)
        feats = [x]
        for i in range(5):
            if i > 0:
                x = c.avg_pool(x, 2)
            x = _conv_unit(x, p, f"unet.path_down.{i}.1", first=(i == 0))
            feats.append(x)
        bot = feats[-1]
        for i, hor in enumerate(feats[-2:0:-1]):
            big = c.resize_bilinear_half_pixel(bot, 2 * bot.shape[-2],
                                               2 * bot.shape[-1])
            bot = _conv_unit(torch.cat([big, hor], dim=1), p,
                             f"unet.path_up.{i}.conv")
        desc = c.l2_normalize(bot[:, :128], dim=1)
        score = torch.sigmoid(bot[:, 128:])
        return score.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)
