"""Kernel E: masked softmax attention on CUDA (csrc/attention.cu).

Replaces keypoint_bench_tpu/ops/pallas_attention.py `_kernel` (via
`fused_attention`). The plain twin is ops/attention.py `fused_attention`;
`masked_attention` takes it for CPU tensors only. For CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from keypoint_bench_tpu_torch.ops._build import Kernel

HEAD_DIM = 64   # the kernel's feature width (LightGlue: 256 / 4 heads)
# csrc/attention.cu's tile: query rows of a block, keys of one ring stage
# (kbt_attention_tiles reports the built kernel's own)
BQ, BK = 256, 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("attention", "kbt_attention",
                [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P])


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_valid: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """q [..., n, dh], k/v [..., m, dh], kv_valid [..., m] -> [..., n, dh],
    as attention.fused_attention computes it. A caller that attends with
    one mask many times hands it over already expanded to q's leading dims
    and contiguous (`head_mask`): the kernel then reads it where it lies."""
    if not q.is_cuda:
        from keypoint_bench_tpu_torch.ops.attention import fused_attention
        return fused_attention(q, k, v, kv_valid, scale)
    return attention_cuda(q, k, v, kv_valid, scale)


def head_mask(valid: torch.Tensor, num_heads: int) -> torch.Tensor:
    """valid [..., m] bool -> contiguous [..., num_heads, m] bool: the mask
    of every (batch, head) slice, made once for all the calls that use it.
    Kernel E reads a bool tensor's bytes as they are, so a mask of this
    shape costs a call no launch of its own."""
    return valid[..., None, :].expand(*valid.shape[:-1], num_heads,
                                      valid.shape[-1]).contiguous()


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: torch.Tensor,
                   scale: float | None = None) -> torch.Tensor:
    """Launch kernel E once over every slice of the leading dims."""
    KERNEL.function()   # builds, or raises, before any launch
    dev = q.device
    for t in (q, k, v, kv_valid):
        if not t.is_cuda or t.device != dev:
            raise ValueError("attention_cuda takes CUDA tensors on one "
                             "device")
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise ValueError(f"expected float32, got {t.dtype}")
    if kv_valid.dtype != torch.bool:
        raise ValueError(f"kv_valid must be bool, got {kv_valid.dtype}")
    lead, (n, dh) = q.shape[:-2], q.shape[-2:]
    m = k.shape[-2]
    if (dh != HEAD_DIM or k.shape != (*lead, m, dh) or v.shape != k.shape
            or not q.numel() or not k.numel()):
        raise ValueError(f"expected non-empty q [..., n, {HEAD_DIM}] and "
                         f"k/v [..., m, {HEAD_DIM}] with equal leading dims; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if scale is None:
        scale = dh ** -0.5
    q3 = q.reshape(-1, n, dh).contiguous()
    k3 = k.reshape(-1, m, dh).contiguous()
    v3 = v.reshape(-1, m, dh).contiguous()
    # a bool tensor stores one byte, 0 or 1, per element: no conversion; a
    # mask already of q's leading dims (head_mask) is not copied either
    mask = kv_valid.expand(*lead, m).reshape(-1, m).contiguous().view(
        torch.uint8)
    if any(t.data_ptr() % 16 for t in (q3, k3, v3)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q3)
    with torch.cuda.device(dev):
        KERNEL.launch(1, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                      mask.data_ptr(), out.data_ptr(), q3.shape[0], n, m,
                      float(scale), torch.cuda.current_stream().cuda_stream)
    return out.reshape(q.shape)
