"""ALIKE-t detector/descriptor (counterpart of keypoint_bench_tpu/models/alike.py
and, for `feats`, of models/alike_s2d.alike_s2d_feats_cm).

ConvBlock encoder + three residual blocks behind max pools of 2/4/4, four
1x1 branch convs, align-corners bilinear upsampling and one 1x1 head that
emits 64 descriptor channels and one sigmoid score channel. `Alike_s2d` is
registered as the same class: its space-to-depth stem and channel-major
emit are TPU lane workarounds, not different math.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


@register("Alike_s2d")
@register("Alike")
class Alike(c.ParamModule):

    def _branches(self, image: torch.Tensor):
        """NHWC image -> (params, [a1, a2, a3, a4]) post-ReLU NCHW branch
        features at H, H/2, H/8, H/32."""
        p = self.params
        # contiguous NCHW (the sampler kernel takes channel-major branch
        # features)
        x = c.nchw_image(image)
        x1 = c.conv_block(x, p, "block1")
        x2 = c.res_block(c.max_pool(x1, 2), p, "block2")
        x3 = c.res_block(c.max_pool(x2, 4), p, "block3")
        x4 = c.res_block(c.max_pool(x3, 4), p, "block4")
        feats = [c.relu(c.conv2d(xi, p[f"conv{i}.weight"],
                                 p.get(f"conv{i}.bias")))
                 for i, xi in enumerate((x1, x2, x3, x4), start=1)]
        return p, feats

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (score [B,H,W,1], desc [B,H,W,64])."""
        p, (a1, a2, a3, a4) = self._branches(image)
        agg = torch.cat([a1, c.upsample_bilinear_align(a2, 2),
                         c.upsample_bilinear_align(a3, 8),
                         c.upsample_bilinear_align(a4, 32)], dim=1)
        head = c.conv2d(agg, p["convhead2.weight"], p.get("convhead2.bias"))
        head = head.permute(0, 2, 3, 1)
        return torch.sigmoid(head[..., -1:]), head[..., :-1]

    def feats(self, image: torch.Tensor):
        """image [B,H,W,3] -> (score [B,H,W,1], (f1t [B,16,H,W],
        f2t [B,16,H/2,W/2], f3t [B,16,H/8,W/8], f4t [B,16,H/32,W/32])).

        No dense descriptor map: the score channel of the 1x1 head is
        projected per branch before upsampling (upsampling and the head are
        linear, so they commute), and descriptors are sampled later at the
        keypoints only (ops/sparse_desc.py). Equal to `forward`'s score up
        to float summation order."""
        p, feats = self._branches(image)
        wh = p["convhead2.weight"][-1, :, 0, 0]                    # [64]
        per = feats[0].shape[1]
        h, w = feats[0].shape[-2], feats[0].shape[-1]
        score = None
        for i, a in enumerate(feats):
            s = torch.einsum("bchw,c->bhw", a, wh[i * per:(i + 1) * per])
            s = s[:, None]
            if i:
                s = c.resize_bilinear_align(s, h, w)
            score = s if score is None else score + s
        bh = p.get("convhead2.bias")
        if bh is not None:
            score = score + bh[-1]
        return torch.sigmoid(score).permute(0, 2, 3, 1), tuple(feats)
