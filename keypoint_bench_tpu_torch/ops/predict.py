"""Soft position prediction from descriptor similarity (counterpart of
keypoint_bench_tpu/ops/predict.py; reference utils/extracter.py:103-126
`predict_positions`): desc-similarity softmax with temperature 0.01 and a
0.01 dustbin column -> expected (x, y) per source position, plus the
bilinearly-sampled self-similarity score at the predicted position.

The two products are plain `torch.matmul` (TF32 off, device.py), as the
JAX package leaves them to XLA; each row's sample of its own similarity
map is one batched four-tap gather.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.ops.grid_sample import sample_bilinear_pixels


def predict_positions(desc0: torch.Tensor,
                      desc1: torch.Tensor) -> torch.Tensor:
    """desc maps [H, W, D] -> [H*W, 3] of (x, y in [0,1], score)."""
    h, w, d = desc0.shape
    kw = {"dtype": desc0.dtype, "device": desc0.device}
    xs = torch.linspace(1 / w / 2, 1 - 1 / w / 2, w, **kw)
    ys = torch.linspace(1 / h / 2, 1 - 1 / h / 2, h, **kw)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)  # [HW, 2]

    f0 = desc0.reshape(-1, d)
    f1 = desc1.reshape(-1, d)
    sim = f0 @ f1.T                                              # [HW, HW]
    dustbin = torch.full((sim.shape[0], 1), 0.01, **kw)
    simd = torch.cat([sim, dustbin], dim=1)
    max_v = simd.amax(1, keepdim=True)
    x_exp = torch.exp((simd - max_v) / 0.01)[:, :-1]            # [HW, HW]

    denom = x_exp.sum(1, keepdim=True)
    xy = (x_exp @ grid) / denom                                  # [HW, 2]

    # per-row bilinear sample of its own similarity map at the predicted xy
    # (reference samples with align_corners=True on pts*2-1)
    px = xy[:, 0] * (w - 1)
    py = xy[:, 1] * (h - 1)
    scores = sample_bilinear_pixels(x_exp.reshape(-1, h, w, 1), px[:, None],
                                    py[:, None])[:, 0, 0]
    return torch.cat([xy, scores[:, None]], dim=1)
