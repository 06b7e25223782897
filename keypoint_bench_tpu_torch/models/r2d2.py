"""R2D2 Quad_L2Net_ConfCFS (counterpart of keypoint_bench_tpu/models/r2d2.py;
reference models/r2d2.py:36-141): a dilated L2-Net of six 3x3 convs, the
dilation doubling at the virtual-stride layers, then three 2x2 dilated
convs padded ((k-1)*d)//2; BatchNorm without affine; heads on x^2: a
2-channel reliability (softmax, channel 1) and a 1-channel repeatability
(softplus / (1 + softplus)); score = their product, desc = the
L2-normalized 128-d full-resolution map.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register

# (ops index of the conv, dilation, has BatchNorm, has ReLU, padding)
_LAYERS = [
    (0, 1, True, True, 1),
    (3, 1, True, True, 1),
    (6, 1, True, True, 1),
    (9, 2, True, True, 2),
    (12, 2, True, True, 2),
    (15, 4, True, True, 4),
    (18, 4, True, False, 2),
    (20, 8, True, False, 4),
    (22, 16, False, False, 8),
]


@register("r2d2")
class R2D2(c.ParamModule):

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] -> (score [B,H,W,1], desc [B,H,W,128])."""
        p = self.params
        x = c.nchw_image(image)
        for idx, dil, has_bn, has_relu, pad in _LAYERS:
            w, b = p[f"ops.{idx}.weight"], p.get(f"ops.{idx}.bias")
            if has_bn:
                x = c.conv_bn(x, w, b, (None, None,
                                        p[f"ops.{idx + 1}.running_mean"],
                                        p[f"ops.{idx + 1}.running_var"]),
                              1, pad, dil, relu=has_relu)
            else:
                x = c.conv2d(x, w, b, 1, pad, dilation=dil)
                x = c.relu(x) if has_relu else x
        x2 = x * x
        urel = c.conv2d(x2, p["clf.weight"], p.get("clf.bias"))
        urep = c.conv2d(x2, p["sal.weight"], p.get("sal.bias"))
        rel = torch.softmax(urel, dim=1)[:, 1:2]
        sp = F.softplus(urep)
        rep = sp / (1 + sp)
        desc = c.l2_normalize(x, dim=1)
        return (rep * rel).permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)
