"""EdgePoint (counterpart of keypoint_bench_tpu/models/edgepoint.py;
reference models/EdgePoint.py:84-175): the ALIKE-family encoder;
descriptors aggregated at H/8 from strided 1x1 convs (x1: stride 8, x2:
stride 4), x3 as it is and a 4x4 / stride-4 ConvTranspose of x4; a 1x1
score head on the full-resolution x1 branch. The score is raw (no
sigmoid); the descriptor map is D-wide at H/8, not normalized.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


@register("EdgePoint")
class EdgePoint(c.ParamModule):

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] (H, W multiples of 32) -> (score [B,H,W,1],
        desc [B,H/8,W/8,D])."""
        p = self.params
        x1 = c.conv_block(c.nchw_image(image), p, "block1")
        x2 = c.res_block(c.max_pool(x1, 2), p, "block2")
        x3 = c.res_block(c.max_pool(x2, 4), p, "block3")
        x4 = c.res_block(c.max_pool(x3, 4), p, "block4")
        a1, a2, a3, a4 = (
            c.relu(c.conv2d(xi, p[f"conv{i}.weight"], p.get(f"conv{i}.bias")))
            for i, xi in enumerate((x1, x2, x3, x4), start=1))
        agg = torch.cat([
            c.conv2d(a1, p["conv_8.weight"], p.get("conv_8.bias"), 8),
            c.conv2d(a2, p["conv_4.weight"], p.get("conv_4.bias"), 4),
            a3,
            c.conv_transpose2d(a4, p["conv_transpose_4.weight"],
                               p.get("conv_transpose_4.bias"), 4)], dim=1)
        desc = c.conv2d(agg, p["convhead2.weight"], p.get("convhead2.bias"))
        score = c.conv2d(a1, p["conv_score.weight"], p.get("conv_score.bias"))
        return score.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)
