"""The plain forwards of the benchmark's two models, in float32, NCHW.

Weights are read here from the converted `.npz` files (conv kernels HWIO,
the JAX layout) and put into torch's OIHW; nothing the program loaded is
used.

- ALIKE-t (Zhao et al., arXiv:2112.02906): a conv block at full
  resolution, three residual blocks behind max pools of 2, 4 and 4, four
  1x1 branch convs to 16 channels each, the branches upsampled
  (bilinear, align corners) to full resolution, concatenated, and one 1x1
  head: 64 descriptor channels (not normalised) and a sigmoid score.
- R2D2 Quad_L2Net_ConfCFS (Revaud et al., arXiv:1906.06195): nine dilated
  convs at full resolution with BatchNorm (no affine) and ReLU as listed
  in `R2D2_LAYERS`, then on x^2 a 2-channel reliability (softmax,
  channel 1) and a 1-channel repeatability (softplus / (1 + softplus));
  score = their product; descriptors = x L2-normalised over 128
  channels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# (conv index, dilation, BatchNorm, ReLU, padding) of R2D2's trunk
R2D2_LAYERS = [
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


def load_weights(path: str, device, meta: bool = False) -> dict:
    """{name: float32 tensor in torch layout} from a JAX-layout npz; with
    `meta`, empty tensors of those shapes on the meta device."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            a = data[k]
            if a.ndim == 4:
                a = np.transpose(a, (3, 2, 0, 1))      # HWIO -> OIHW
            elif a.ndim == 2:
                a = a.T
            if meta:
                out[k] = torch.empty(a.shape, device="meta")
            else:
                out[k] = torch.from_numpy(np.ascontiguousarray(
                    a, np.float32)).to(device)
    return out


def image_nchw(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] -> float32 [B,3,H,W] in [0, 1]."""
    return (imgs.float() / 255.0).permute(0, 3, 1, 2).contiguous()


def _bn(x, p, name):
    """BatchNorm in inference, with affine where the weights have it."""
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p.get(f"{name}.weight"),
                        p.get(f"{name}.bias"), False, 0.0, 1e-5)


def _conv_bn_relu(x, p, conv, bn, padding=1):
    x = F.conv2d(x, p[f"{conv}.weight"], p.get(f"{conv}.bias"), 1, padding)
    return F.relu(_bn(x, p, bn))


def _res_block(x, p, name):
    idn = F.conv2d(x, p[f"{name}.downsample.weight"],
                   p.get(f"{name}.downsample.bias"))
    y = _conv_bn_relu(x, p, f"{name}.conv1", f"{name}.bn1")
    y = F.conv2d(y, p[f"{name}.conv2.weight"], p.get(f"{name}.conv2.bias"),
                 1, 1)
    return F.relu(_bn(y, p, f"{name}.bn2") + idn)


def alike(p: dict, x: torch.Tensor):
    """x [B,3,H,W] -> (score [B,H,W], descriptors [B,64,H,W])."""
    x1 = _conv_bn_relu(x, p, "block1.conv1", "block1.bn1")
    x1 = _conv_bn_relu(x1, p, "block1.conv2", "block1.bn2")
    x2 = _res_block(F.max_pool2d(x1, 2), p, "block2")
    x3 = _res_block(F.max_pool2d(x2, 4), p, "block3")
    x4 = _res_block(F.max_pool2d(x3, 4), p, "block4")
    h, w = x.shape[-2:]
    branches = []
    for i, xi in enumerate((x1, x2, x3, x4), start=1):
        b = F.relu(F.conv2d(xi, p[f"conv{i}.weight"], p.get(f"conv{i}.bias")))
        if i > 1:
            b = F.interpolate(b, size=(h, w), mode="bilinear",
                              align_corners=True)
        branches.append(b)
    head = F.conv2d(torch.cat(branches, 1), p["convhead2.weight"],
                    p.get("convhead2.bias"))
    return torch.sigmoid(head[:, -1]), head[:, :-1]


def r2d2(p: dict, x: torch.Tensor):
    """x [B,3,H,W] -> (score [B,H,W], descriptors [B,128,H,W])."""
    for idx, dil, has_bn, has_relu, pad in R2D2_LAYERS:
        x = F.conv2d(x, p[f"ops.{idx}.weight"], p.get(f"ops.{idx}.bias"), 1,
                     pad, dil)
        if has_bn:
            x = _bn(x, p, f"ops.{idx + 1}")
        if has_relu:
            x = F.relu(x)
    x2 = x * x
    rel = torch.softmax(F.conv2d(x2, p["clf.weight"], p["clf.bias"]), 1)[:, 1]
    sp = F.softplus(F.conv2d(x2, p["sal.weight"], p["sal.bias"]))[:, 0]
    return sp / (1 + sp) * rel, x / torch.sqrt((x * x).sum(1, keepdim=True))


FORWARDS = {"Alike": alike, "r2d2": r2d2}
