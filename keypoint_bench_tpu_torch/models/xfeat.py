"""XFeat (counterpart of keypoint_bench_tpu/models/xfeat.py; reference
models/XFeat.py:22-140).

Grayscale as the channel mean, affine-free InstanceNorm, a strided encoder
of five blocks with an average-pool skip, pyramid fusion at 1/8 (half-pixel
bilinear upsampling of the 1/16 and 1/32 maps), L2-normalized 64-d
features; the keypoint head runs on the 8 x 8 unfold of the normalized
image: 65 logits, softmax, dustbin dropped, depth-to-space heatmap. NCHW
inside, NHWC at the boundary, as the port's SuperPoint.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register


def _basic(x, p, prefix: str, stride: int = 1, padding: int = 1):
    """BasicLayer: conv (no bias) + BatchNorm without affine + ReLU
    (reference XFeat.py:7-19)."""
    x = c.conv2d(x, p[f"{prefix}.layer.0.weight"], None, stride, padding)
    mean = p[f"{prefix}.layer.1.running_mean"][:, None, None]
    var = p[f"{prefix}.layer.1.running_var"][:, None, None]
    return c.relu((x - mean) * torch.rsqrt(var + 1e-5))


@register("XFeat")
class XFeat(c.ParamModule):

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] (uint8, or float in [0,1]), H and W multiples of
        32 -> (heat [B,H,W,1], feats [B,H/8,W/8,64])."""
        p = self.params
        x = c.to_float_image(image).mean(-1)[:, None].contiguous()
        x = c.instance_norm(x)

        x1 = x
        for i in range(4):
            x1 = _basic(x1, p, f"block1.{i}", stride=2 if i in (1, 3) else 1)
        x2 = x1 + c.conv2d(c.avg_pool(x, 4), p["skip1.1.weight"],
                           p.get("skip1.1.bias"))
        for i in range(2):
            x2 = _basic(x2, p, f"block2.{i}")
        x3 = _basic(x2, p, "block3.0", stride=2)
        x3 = _basic(x3, p, "block3.1")
        x3 = _basic(x3, p, "block3.2", padding=0)    # 1x1
        x4 = _basic(x3, p, "block4.0", stride=2)
        x4 = _basic(x4, p, "block4.1")
        x4 = _basic(x4, p, "block4.2")
        x5 = _basic(x4, p, "block5.0", stride=2)
        x5 = _basic(x5, p, "block5.1")
        x5 = _basic(x5, p, "block5.2")
        x5 = _basic(x5, p, "block5.3", padding=0)    # 1x1

        h3, w3 = x3.shape[-2], x3.shape[-1]
        f = (x3 + c.resize_bilinear_half_pixel(x4, h3, w3)
             + c.resize_bilinear_half_pixel(x5, h3, w3))
        f = _basic(f, p, "block_fusion.0")
        f = _basic(f, p, "block_fusion.1")
        feats = c.conv2d(f, p["block_fusion.2.weight"],
                         p.get("block_fusion.2.bias"))
        feats = c.l2_normalize(feats, dim=1)

        # the JAX package's `_unfold8` (channel h_off * 8 + w_off) is a
        # pixel unshuffle of the one-channel image
        k = F.pixel_unshuffle(x, 8)
        for i in range(3):
            k = _basic(k, p, f"keypoint_head.{i}", padding=0)
        logits = c.conv2d(k, p["keypoint_head.3.weight"],
                          p.get("keypoint_head.3.bias"))
        heat = c.depth_to_space(torch.softmax(logits, dim=1)[:, :64], 8)
        return heat.permute(0, 2, 3, 1), feats.permute(0, 2, 3, 1)
