"""LETNet (counterpart of keypoint_bench_tpu/models/letnet.py; reference
models/LETNet.py:31-52): ConvBlock + 1x1 conv + ReLU + 1x1 head -> 4
channels; channel 3 is the sigmoid score, channels 0-2 the sigmoid local
descriptor at full resolution. `LETNet_s2d` is registered as the same
class: the JAX package's space-to-depth stem (models/tiny_s2d.py) is a
TPU layout workaround, not different math.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


@register("LETNet_s2d")
@register("LETNet")
class LETNet(c.ParamModule):

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (score [B,H,W,1], desc [B,H,W,3])."""
        p = self.params
        x = c.nchw_image(image)
        x = c.conv_block(x, p, "block1")
        x = c.relu(c.conv2d(x, p["conv1.weight"], p.get("conv1.bias")))
        x = c.conv2d(x, p["conv_head.weight"], p.get("conv_head.bias"))
        x = torch.sigmoid(x).permute(0, 2, 3, 1)
        return x[..., 3:4], x[..., 0:3]
