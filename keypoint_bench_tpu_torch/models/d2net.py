"""D2-Net (counterpart of keypoint_bench_tpu/models/d2net.py; reference
models/D2_Net.py:84-105): VGG16 features to conv4_3 (convs with bias, 3
max pools, relu4_3 left out), soft local-max detection (exp ratio inside
3x3 windows with constant-1 padding times the channel-max ratio, then
normalized to sum 1 per image), the score resized to full resolution
(bilinear, align corners); the 512-d L2-normalized descriptor map at H/8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.models.registry import register

# torchvision VGG16 `features` indices up to conv4_3 ("M" = max pool 2)
_VGG = [0, 2, "M", 5, 7, "M", 10, 12, 14, "M", 17, 19, 21]


def soft_detection(batch: torch.Tensor) -> torch.Tensor:
    """SoftDetectionModule (D2_Net.py:49-81) of NCHW features -> the
    [B,1,H,W] score, summing to 1 per image."""
    b = batch.shape[0]
    batch = c.relu(batch)
    max_per_sample = batch.reshape(b, -1).amax(1)
    exp = torch.exp(batch / max_per_sample.reshape(b, 1, 1, 1))
    sum_exp = F.avg_pool2d(F.pad(exp, (1, 1, 1, 1), value=1.0), 3, 1,
                           divisor_override=1)
    local_max_score = exp / sum_exp
    depth_wise_max = batch.amax(1, keepdim=True)
    score = (local_max_score * (batch / depth_wise_max)).amax(1,
                                                              keepdim=True)
    return score / score.reshape(b, -1).sum(1).reshape(b, 1, 1, 1)


@register("D2Net")
class D2Net(c.ParamModule):

    def features(self, image: torch.Tensor) -> torch.Tensor:
        """image [B,H,W,3] -> conv4_3 features [B,512,H/8,W/8] (NCHW)."""
        p = self.params
        x = c.nchw_image(image)
        for i, idx in enumerate(_VGG):
            if idx == "M":
                x = c.max_pool(x, 2)
                continue
            key = f"dense_feature_extraction.model.{idx}"
            x = c.conv2d(x, p[f"{key}.weight"], p.get(f"{key}.bias"), 1, 1)
            if i != len(_VGG) - 1:   # the reference stops at conv4_3
                x = c.relu(x)
        return x

    def forward(self, image: torch.Tensor):
        """image [B,H,W,3] (H, W multiples of 8) -> (score [B,H,W,1],
        desc [B,H/8,W/8,512])."""
        feat = self.features(image)
        score = c.resize_bilinear_align(soft_detection(feat),
                                        image.shape[1], image.shape[2])
        desc = c.l2_normalize(feat, dim=1)
        return score.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)
