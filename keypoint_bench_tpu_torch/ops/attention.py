"""Masked softmax attention: the plain twin of kernel E (counterpart of
keypoint_bench_tpu/ops/pallas_attention.py `fused_attention`).

ops/cuda_attention.py `masked_attention` takes this function for CPU
tensors and launches kernel E (csrc/attention.cu) for CUDA tensors.
"""
from __future__ import annotations

import torch

NEG = -1e9   # the score of a masked key, before the softmax


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """q [..., n, dh], k/v [..., m, dh], kv_valid [..., m] bool
    (broadcastable to q's leading dims) -> [..., n, dh] f32.

    scale defaults to dh**-0.5; pass 1.0 when q and k are pre-scaled (the
    LightGlue cross block splits the scale across both sides). Invalid keys
    score -1e9 before the softmax, so a row whose keys are all invalid is
    uniform over the m keys."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(kv_valid[..., None, :], s, torch.full_like(s, NEG))
    return torch.softmax(s, dim=-1) @ v.float()
