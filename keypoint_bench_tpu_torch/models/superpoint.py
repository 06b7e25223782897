"""SuperPoint (counterpart of keypoint_bench_tpu/models/superpoint.py;
reference models/SuperPoint.py:6-71).

Channel sum to grayscale, a VGG-style encoder of four conv stages behind
three 2x2 max pools, then two heads at 1/8 resolution: the detector
(convPa/Pb, 65 channels, softmax, dustbin dropped, 8x8 depth-to-space
heatmap) and the descriptor (convDa/Db, 256 channels, L2-normalized).
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


@register("SuperPoint")
class SuperPoint(c.ParamModule):

    def _conv_relu(self, p, x, name: str, pad: int = 1):
        return c.relu(c.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                               1, pad))

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] (uint8, or float in [0,1]) -> (heat [B,H,W,1],
        desc [B,H/8,W/8,256])."""
        p = self.params
        x = c.to_float_image(image).sum(-1)[:, None].contiguous()
        for stage in ("1", "2", "3"):
            x = self._conv_relu(p, x, f"conv{stage}a")
            x = c.max_pool(self._conv_relu(p, x, f"conv{stage}b"), 2)
        x = self._conv_relu(p, x, "conv4a")
        x = self._conv_relu(p, x, "conv4b")
        semi = c.conv2d(self._conv_relu(p, x, "convPa"), p["convPb.weight"],
                        p.get("convPb.bias"))
        desc = c.conv2d(self._conv_relu(p, x, "convDa"), p["convDb.weight"],
                        p.get("convDb.bias"))
        desc = c.l2_normalize(desc, dim=1)
        dense = torch.softmax(semi, dim=1)
        heat = c.depth_to_space(dense[:, :-1], 8)
        return heat.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)
