"""LightGlue matcher in deterministic mode (counterpart of
keypoint_bench_tpu/models/lightglue.py; reference models/lightglue.py).

Nine layers of rotary self-attention and bidirectional cross-attention
over two fixed-K keypoint sets with validity masks, a learnable Fourier
positional encoding, and the sigmoid-log-double-softmax assignment with
mutual-max filtering. Fixed depth, no pruning: the reference with
depth_confidence = width_confidence = -1. Every function takes leading
batch dimensions, so one call serves B pairs.

Attention forms (`attn`):
  - "dense": one [K0, K1] similarity per head, shared by both cross
    directions (softmax over either axis);
  - "fused": masked attention through ops/cuda_attention.masked_attention,
    two passes with q and k swapped in the cross block. CUDA tensors run
    kernel E, CPU tensors its plain twin.
  - "auto" (default): "fused" on CUDA, at every K; "dense" on the CPU.
Parameters are torch-layout tensors (weights/convert.py: linears [out, in]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from keypoint_bench_tpu_torch.ops.cuda_attention import (head_mask,
                                                         masked_attention)
from keypoint_bench_tpu_torch.ops.grid_sample import sample_bilinear_pixels

NEG = -1e9


def _linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def _layernorm(p: dict, name: str, x: torch.Tensor, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p[f"{name}.weight"] \
        + p[f"{name}.bias"]


def _ffn(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    y = _linear(p, f"{prefix}.0", x)
    y = _layernorm(p, f"{prefix}.1", y)
    return _linear(p, f"{prefix}.3", F.gelu(y, approximate="none"))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _apply_rotary(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """freqs [2, ..., N, dh]; t [..., h, N, dh]."""
    cos, sin = freqs[0][..., None, :, :], freqs[1][..., None, :, :]
    return t * cos + _rotate_half(t) * sin


def _posenc(p: dict, kpts: torch.Tensor) -> torch.Tensor:
    """LearnableFourierPositionalEncoding: kpts [..., N, 2] -> freqs
    [2, ..., N, head_dim] (cos / sin, each pair of features duplicated)."""
    proj = F.linear(kpts, p["posenc.Wr.weight"])            # [..., N, F/2]
    emb = torch.stack([torch.cos(proj), torch.sin(proj)], dim=0)
    return torch.repeat_interleave(emb, 2, dim=-1)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., N, d] -> [..., h, N, d/h]."""
    return x.unflatten(-1, (num_heads, -1)).transpose(-3, -2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[..., h, N, dh] -> [..., N, h*dh]."""
    return x.transpose(-3, -2).flatten(-2)


def _attention(q, k, v, mask_kv, attn: str, scale: float | None = None):
    """q [..., h, N, dh], k/v [..., h, M, dh] -> [..., h, N, dh]. mask_kv
    is [..., M] bool for "dense" and the per-head [..., h, M] of
    `head_mask` for "fused" (made once per call of the matcher, not once
    per attention)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if attn == "fused":
        return masked_attention(q, k, v, mask_kv, scale)
    sim = (q @ k.transpose(-1, -2)) * scale
    sim = torch.where(mask_kv[..., None, None, :], sim,
                      torch.full_like(sim, NEG))
    return torch.softmax(sim, dim=-1) @ v


def _self_block(p, prefix, x, enc, valid, num_heads, attn):
    qkv = _linear(p, f"{prefix}.Wqkv", x)                 # [..., N, 3d]
    qkv = qkv.unflatten(-1, (num_heads, -1, 3))           # [..., N, h, dh, 3]
    q, k, v = (qkv[..., i].transpose(-3, -2) for i in range(3))
    q = _apply_rotary(enc, q)
    k = _apply_rotary(enc, k)
    ctx = _attention(q, k, v, valid, attn)
    msg = _linear(p, f"{prefix}.out_proj", _merge(ctx))
    return x + _ffn(p, f"{prefix}.ffn", torch.cat([x, msg], dim=-1))


def _cross_block(p, prefix, x0, x1, valid0, valid1, num_heads, attn,
                 valid10=None):
    """valid0 / valid1 as `_attention` takes them; valid10 is the "fused"
    mask of the stacked pass, `head_mask` of [valid1, valid0], when both
    sides hold as many keypoints."""
    qk0 = _heads(_linear(p, f"{prefix}.to_qk", x0), num_heads)
    qk1 = _heads(_linear(p, f"{prefix}.to_qk", x1), num_heads)
    v0 = _heads(_linear(p, f"{prefix}.to_v", x0), num_heads)
    v1 = _heads(_linear(p, f"{prefix}.to_v", x1), num_heads)
    scale = qk0.shape[-1] ** -0.5
    qk0 = qk0 * scale ** 0.5
    qk1 = qk1 * scale ** 0.5
    if attn == "fused":
        # two passes with q and k swapped instead of one shared sim; when
        # both sides hold K keypoints, one launch serves both directions
        if qk0.shape == qk1.shape:
            m = _attention(torch.stack([qk0, qk1]), torch.stack([qk1, qk0]),
                           torch.stack([v1, v0]), valid10, attn, 1.0)
            m0, m1 = m[0], m[1]
        else:
            m0 = _attention(qk0, qk1, v1, valid1, attn, 1.0)
            m1 = _attention(qk1, qk0, v0, valid0, attn, 1.0)
    else:
        sim = qk0 @ qk1.transpose(-1, -2)                 # [..., h, K0, K1]
        sim01 = torch.where(valid1[..., None, None, :], sim,
                            torch.full_like(sim, NEG))
        sim10 = torch.where(valid0[..., None, :, None], sim,
                            torch.full_like(sim, NEG))
        m0 = torch.softmax(sim01, dim=-1) @ v1
        m1 = torch.softmax(sim10, dim=-2).transpose(-1, -2) @ v0
    m0 = _linear(p, f"{prefix}.to_out", _merge(m0))
    m1 = _linear(p, f"{prefix}.to_out", _merge(m1))
    x0 = x0 + _ffn(p, f"{prefix}.ffn", torch.cat([x0, m0], dim=-1))
    x1 = x1 + _ffn(p, f"{prefix}.ffn", torch.cat([x1, m1], dim=-1))
    return x0, x1


def _assignment_scores(p, prefix, d0, d1, valid0, valid1):
    """MatchAssignment + sigmoid_log_double_softmax, masked: the
    [..., K0, K1] log scores."""
    md0 = _linear(p, f"{prefix}.final_proj", d0)
    md1 = _linear(p, f"{prefix}.final_proj", d1)
    d = md0.shape[-1]
    md0 = md0 / d ** 0.25
    md1 = md1 / d ** 0.25
    sim = md0 @ md1.transpose(-1, -2)
    sim = torch.where(valid0[..., :, None] & valid1[..., None, :], sim,
                      torch.full_like(sim, NEG))
    z0 = _linear(p, f"{prefix}.matchability", d0)            # [..., K0, 1]
    z1 = _linear(p, f"{prefix}.matchability", d1)            # [..., K1, 1]
    cert = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(-1, -2)
    return (torch.log_softmax(sim, dim=-1) + torch.log_softmax(sim, dim=-2)
            + cert)


def normalize_keypoints_masked(kpts: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """normalize_keypoints with size=None: size = 1 + max - min over the
    valid keypoints only. kpts [..., N, 2], valid [..., N]."""
    big = 1e9
    v = valid[..., None]
    kmax = torch.where(v, kpts, torch.full_like(kpts, -big)).amax(-2)
    kmin = torch.where(v, kpts, torch.full_like(kpts, big)).amin(-2)
    size = 1.0 + kmax - kmin
    shift = size / 2.0
    scale = size.amax(-1) / 2.0
    return (kpts - shift[..., None, :]) / scale[..., None, None]


def sample_descriptors_lg(kpts_px: torch.Tensor, desc_map: torch.Tensor,
                          s: int) -> torch.Tensor:
    """Reference sample_descriptors: kpts_px [..., K, 2] image pixels,
    desc_map [..., h, w, C] at stride s; the grid
    (kp - s/2 + 0.5) / (w*s - s/2 - 0.5) * 2 - 1 with align_corners=True;
    output L2-normalized (norm floored at 1e-12)."""
    h, w = desc_map.shape[-3], desc_map.shape[-2]
    kx = (kpts_px[..., 0] - s / 2 + 0.5) / (w * s - s / 2 - 0.5)
    ky = (kpts_px[..., 1] - s / 2 + 0.5) / (h * s - s / 2 - 0.5)
    d = sample_bilinear_pixels(desc_map, kx * (w - 1), ky * (h - 1))
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d / torch.clamp_min(n, 1e-12)


def resolve_attn(attn: str, device: torch.device) -> str:
    """'auto' -> 'fused' on CUDA (kernel E at every K), 'dense' on the CPU.
    CUDA tensors always take the fused form."""
    if attn not in ("auto", "dense", "fused"):
        raise ValueError(f"unknown attn {attn!r}")
    if device.type == "cuda":
        if attn == "dense":
            raise ValueError("CUDA tensors run the fused form (kernel E)")
        return "fused"
    return "dense" if attn == "auto" else attn


@torch.inference_mode()
def lightglue_scores(params: dict, kpts0_px, valid0, desc0, kpts1_px, valid1,
                     desc1, n_layers: int = 9, num_heads: int = 4,
                     attn: str = "auto") -> torch.Tensor:
    """The transformer and the assignment head: kpts*_px [..., K, 2] pixel
    coordinates, valid* [..., K] bool, desc* [..., K, input_dim] ->
    log assignment scores [..., K0, K1]."""
    attn = resolve_attn(attn, desc0.device)
    p = params
    if "input_proj.weight" in p:
        desc0 = _linear(p, "input_proj", desc0)
        desc1 = _linear(p, "input_proj", desc1)
    enc0 = _posenc(p, normalize_keypoints_masked(kpts0_px, valid0))
    enc1 = _posenc(p, normalize_keypoints_masked(kpts1_px, valid1))

    same = desc0.shape == desc1.shape
    # every layer attends with the same masks, so the "fused" form's
    # per-head masks are made here, once: m0 / m1 for one side at a time,
    # m01 / m10 for both sides stacked on a new leading dim
    fused = attn == "fused"
    m0, m1, m01, m10 = valid0, valid1, None, None
    if same:
        # both sides through one self block
        enc01 = torch.stack([enc0, enc1], dim=1)
        m01 = torch.stack([valid0, valid1])
        if fused:
            m01 = head_mask(m01, num_heads)
            m10 = head_mask(torch.stack([valid1, valid0]), num_heads)
    elif fused:
        m0, m1 = head_mask(valid0, num_heads), head_mask(valid1, num_heads)
    d0, d1 = desc0, desc1
    for i in range(n_layers):
        pre = f"transformers.{i}"
        if same:
            d01 = _self_block(p, f"{pre}.self_attn", torch.stack([d0, d1]),
                              enc01, m01, num_heads, attn)
            d0, d1 = d01[0], d01[1]
        else:
            d0 = _self_block(p, f"{pre}.self_attn", d0, enc0, m0, num_heads,
                             attn)
            d1 = _self_block(p, f"{pre}.self_attn", d1, enc1, m1, num_heads,
                             attn)
        d0, d1 = _cross_block(p, f"{pre}.cross_attn", d0, d1, m0, m1,
                              num_heads, attn, m10)
    return _assignment_scores(p, f"log_assignment.{n_layers - 1}", d0, d1,
                              valid0, valid1)


@torch.inference_mode()
def lightglue_forward(params: dict, kpts0_px, valid0, desc0, kpts1_px,
                      valid1, desc1, n_layers: int = 9, num_heads: int = 4,
                      filter_threshold: float = 0.1, attn: str = "auto"):
    """Match two keypoint sets (inputs as `lightglue_scores`). Returns (m0
    [..., K0] index into set 1 or -1, mscores0 [..., K0], match_mask
    [..., K0])."""
    scores = lightglue_scores(params, kpts0_px, valid0, desc0, kpts1_px,
                              valid1, desc1, n_layers, num_heads, attn)
    # filter_matches, masked
    m0 = scores.argmax(-1)
    m1 = scores.argmax(-2)
    rows = torch.arange(scores.shape[-2], device=scores.device)
    mutual0 = m1.gather(-1, m0) == rows
    max0 = scores.gather(-1, m0[..., None])[..., 0]
    mscores0 = torch.where(mutual0, torch.exp(max0), torch.zeros_like(max0))
    ok = (mutual0 & (mscores0 > filter_threshold) & valid0
          & valid1.gather(-1, m0))
    return torch.where(ok, m0, torch.full_like(m0, -1)), mscores0, ok


def lightglue_match(params: dict, kpts0, valid0, kpts1, valid1, desc_map0,
                    desc_map1, w: int, h: int, desc_scale: int):
    """Benchmark adapter (reference LightGlue.match): kpts [..., K, 3]
    normalized (x, y, score); desc maps [..., hc, wc, D]; returns
    (m_kpts0 [..., K, 3], m_kpts1 [..., K, 3], match_mask [..., K])."""
    scale = torch.tensor([w - 1.0, h - 1.0], device=kpts0.device)
    p0 = kpts0[..., 0:2] * scale
    p1 = kpts1[..., 0:2] * scale
    d0 = sample_descriptors_lg(p0, desc_map0, desc_scale)
    d1 = sample_descriptors_lg(p1, desc_map1, desc_scale)
    m0, _, ok = lightglue_forward(params, p0, valid0, d0, p1, valid1, d1)
    m1 = kpts1.gather(-2, m0.clamp_min(0)[..., None].expand(
        *m0.shape, kpts1.shape[-1]))
    return kpts0, m1, ok
