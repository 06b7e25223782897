"""GoodPoint (counterpart of keypoint_bench_tpu/models/goodpoint.py;
reference models/GoodPoint.py:84-111): one ConvBlock, a 1x1 3-channel
sigmoid descriptor head and a 3x3 1-channel sigmoid score head.
`GoodPoint_s2d` is registered as the same class (the JAX package's
space-to-depth stem is a TPU layout workaround).
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


@register("GoodPoint_s2d")
@register("GoodPoint")
class GoodPoint(c.ParamModule):

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (score [B,H,W,1], desc [B,H,W,3])."""
        p = self.params
        x = c.nchw_image(image)
        x = c.conv_block(x, p, "block")
        desc = torch.sigmoid(c.conv2d(x, p["conv_head1.weight"],
                                      p.get("conv_head1.bias")))
        score = torch.sigmoid(c.conv2d(x, p["conv_head2.weight"],
                                       p.get("conv_head2.bias"), 1, 1))
        return score.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)
