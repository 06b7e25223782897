"""SFD2 ResSegNetV2 (counterpart of keypoint_bench_tpu/models/sfd2.py;
reference models/sfd2.py:90-185): a conv stem with two stride-2 stages, 3
grouped (groups=32) residual bottleneck blocks at H/4, a SuperPoint-style
65-channel exp-normalized score head at H/8 (convPa stride 2) ->
depth-to-space; 128-d L2-normalized descriptors at H/4; a 3-class
stability head upsampled to full resolution and quantized to {0.1, 0.5,
1.0} (first class on ties, as jnp.argmax), multiplying the score map.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register

STABILITY = (0.1, 0.5, 1.0)


def _conv_bn(x, p, conv: str, bn: str, stride: int = 1, padding: int = 1,
             groups: int = 1, affine: bool = True,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """Conv `conv` (with its bias, if it has one), BatchNorm `bn`, ReLU;
    affine=False is the reference's `conv(..., use_bn=True)`
    (sfd2.py:62-88), BatchNorm without affine."""
    gb = (p[f"{bn}.weight"], p[f"{bn}.bias"]) if affine else (None, None)
    return c.conv_bn(x, p[f"{conv}.weight"], p.get(f"{conv}.bias"),
                     gb + (p[f"{bn}.running_mean"], p[f"{bn}.running_var"]),
                     stride, padding, groups=groups, relu=True,
                     residual=residual)


def _res_block(x, p, prefix):
    """Grouped bottleneck (sfd2.py:17-46): 1x1 + BN + ReLU, grouped 3x3 +
    BN + ReLU, 1x1 + BN, add, ReLU; the BNs have affine parameters."""
    out = _conv_bn(x, p, f"{prefix}.conv1", f"{prefix}.bn1", padding=0)
    out = _conv_bn(out, p, f"{prefix}.conv2", f"{prefix}.bn2", groups=32)
    return _conv_bn(out, p, f"{prefix}.conv3", f"{prefix}.bn3", padding=0,
                    residual=x)


def stability(sta: torch.Tensor) -> torch.Tensor:
    """[B,3,H,W] stability logits -> [B,1,H,W] weights: the argmax class
    (the first on ties) mapped to 0.1, 0.5 or 1.0."""
    cls = torch.argmax(sta, dim=1, keepdim=True)
    return torch.where(cls == 0, STABILITY[0],
                       torch.where(cls == 1, STABILITY[1], STABILITY[2]))


@register("sfd2")
class SFD2(c.ParamModule):

    def logits(self, image: torch.Tensor):
        """image [B,H,W,3] (H, W multiples of 8) -> (score before the
        stability weight [B,1,H,W], desc [B,128,H/4,W/4], upsampled
        stability logits [B,3,H,W]), all NCHW."""
        p = self.params
        x = c.nchw_image(image)
        h, w = x.shape[-2], x.shape[-1]
        for conv, bn, stride in (("conv1a.0", "conv1a.1", 1),
                                 ("conv1b.0", "bn1b.0", 2),
                                 ("conv2a.0", "conv2a.1", 1),
                                 ("conv2b.0", "bn2b.0", 2),
                                 ("conv3a.0", "conv3a.1", 1),
                                 ("conv3b.0", "bn3b.0", 1)):
            x = _conv_bn(x, p, conv, bn, stride, affine=False)
        for i in range(3):
            x = _res_block(x, p, f"conv4.{i}")

        cpa = _conv_bn(x, p, "convPa.0", "convPa.1", 2)
        cpa = c.conv2d(cpa, p["convPa.3.weight"], p.get("convPa.3.bias"), 1, 1)
        semi = torch.exp(c.conv2d(cpa, p["convPb.weight"],
                                  p.get("convPb.bias")))
        semi = semi / (semi.sum(1, keepdim=True) + 1e-5)
        score = c.depth_to_space(semi[:, :-1], 8)

        cda = _conv_bn(x, p, "convDa.0", "convDa.1")
        cda = c.conv2d(cda, p["convDa.3.weight"], p.get("convDa.3.bias"), 1, 1)
        desc = c.l2_normalize(c.conv2d(cda, p["convDb.weight"],
                                       p.get("convDb.bias")), dim=1)

        sta = c.conv2d(x, p["ConvSta.weight"], p.get("ConvSta.bias"))
        return score, desc, c.resize_bilinear_half_pixel(sta, h, w)

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (score [B,H,W,1], desc [B,H/4,W/4,128])."""
        score, desc, sta = self.logits(image)
        return ((score * stability(sta)).permute(0, 2, 3, 1),
                desc.permute(0, 2, 3, 1))
