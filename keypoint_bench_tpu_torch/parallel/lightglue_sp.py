"""Sequence-parallel LightGlue: the keypoint tokens of both sets split
over the mesh's 'data' ranks, every attention (rotary self and
bidirectional cross) computed as ring attention (counterpart of
keypoint_bench_tpu/parallel/lightglue_sp.py).

Each rank owns K / n contiguous tokens of each set: the projections, the
rotary encoding and the FFNs are row-local, and the K x K similarity is
never whole on any rank. The keypoints are normalized on the whole sets
before they are split (the statistics need them all); the refined
descriptors are gathered once at the end, and the dense masked
assignment runs on them on every rank. The attention products are plain
matmuls, as in the JAX package, so this path launches no kernel E.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models.lightglue import (
    _apply_rotary, _assignment_scores, _ffn, _linear, _posenc,
    filter_matches, normalize_keypoints_masked)
from keypoint_bench_tpu_torch.parallel.mesh import Mesh
from keypoint_bench_tpu_torch.parallel.ring_attention import (
    _ring_attention_shard, gather_rows, row_block)


# the positional encoding is row-local: a rank encodes its own rows
_posenc_rows = _posenc


def _self_block_ring(mesh, p, prefix, x, enc, valid, num_heads):
    qkv = _linear(p, f"{prefix}.Wqkv", x)
    n = x.shape[0]
    qkv = qkv.reshape(n, num_heads, -1, 3)
    q = _apply_rotary(enc, qkv[..., 0].transpose(0, 1))
    k = _apply_rotary(enc, qkv[..., 1].transpose(0, 1))
    v = qkv[..., 2].transpose(0, 1)
    ctx = _ring_attention_shard(mesh, q, k, v, valid)
    msg = _linear(p, f"{prefix}.out_proj",
                  ctx.transpose(0, 1).reshape(n, -1))
    return x + _ffn(p, f"{prefix}.ffn", torch.cat([x, msg], dim=-1))


def _cross_block_ring(mesh, p, prefix, x0, x1, valid0, valid1, num_heads):
    def heads(t):
        n, d = t.shape
        return t.reshape(n, num_heads, d // num_heads).transpose(0, 1)

    def merge(t):
        h, n, dh = t.shape
        return t.transpose(0, 1).reshape(n, h * dh)

    qk0 = heads(_linear(p, f"{prefix}.to_qk", x0))
    qk1 = heads(_linear(p, f"{prefix}.to_qk", x1))
    v0 = heads(_linear(p, f"{prefix}.to_v", x0))
    v1 = heads(_linear(p, f"{prefix}.to_v", x1))
    m0 = _ring_attention_shard(mesh, qk0, qk1, v1, valid1)
    m1 = _ring_attention_shard(mesh, qk1, qk0, v0, valid0)
    m0 = _linear(p, f"{prefix}.to_out", merge(m0))
    m1 = _linear(p, f"{prefix}.to_out", merge(m1))
    x0 = x0 + _ffn(p, f"{prefix}.ffn", torch.cat([x0, m0], dim=-1))
    x1 = x1 + _ffn(p, f"{prefix}.ffn", torch.cat([x1, m1], dim=-1))
    return x0, x1


@torch.inference_mode()
def lightglue_scores_sp(mesh: Mesh, params: dict, kpts0_px, valid0, desc0,
                        kpts1_px, valid1, desc1, n_layers: int = 9,
                        num_heads: int = 4) -> torch.Tensor:
    """The transformer over the mesh's 'data' ranks and the dense
    assignment head on every rank: one pair, kpts*_px [K, 2], valid* [K],
    desc* [K, D], the whole sets on every rank -> log assignment scores
    [K0, K1] (as `lightglue_scores`). Raises ValueError where the 'data'
    size does not divide K0 or K1."""
    p = params
    k0n = normalize_keypoints_masked(kpts0_px, valid0)
    k1n = normalize_keypoints_masked(kpts1_px, valid1)
    k0n, v0, d0, k1n, v1, d1 = (row_block(mesh, x, 0) for x in
                                (k0n, valid0, desc0, k1n, valid1, desc1))
    if "input_proj.weight" in p:
        d0 = _linear(p, "input_proj", d0)
        d1 = _linear(p, "input_proj", d1)
    enc0 = _posenc_rows(p, k0n)
    enc1 = _posenc_rows(p, k1n)
    for i in range(n_layers):
        pre = f"transformers.{i}"
        d0 = _self_block_ring(mesh, p, f"{pre}.self_attn", d0, enc0, v0,
                              num_heads)
        d1 = _self_block_ring(mesh, p, f"{pre}.self_attn", d1, enc1, v1,
                              num_heads)
        d0, d1 = _cross_block_ring(mesh, p, f"{pre}.cross_attn", d0, d1, v0,
                                   v1, num_heads)
    d0, d1 = gather_rows(mesh, d0, 0), gather_rows(mesh, d1, 0)
    return _assignment_scores(p, f"log_assignment.{n_layers - 1}", d0, d1,
                              valid0, valid1)


def lightglue_forward_sp(mesh: Mesh, params: dict, kpts0_px, valid0, desc0,
                         kpts1_px, valid1, desc1, n_layers: int = 9,
                         num_heads: int = 4, filter_threshold: float = 0.1):
    """Ring-attention LightGlue over the mesh's 'data' ranks, one pair
    (inputs as `lightglue_scores_sp`). Returns (m0, mscores0,
    match_mask) as `lightglue_forward`, on every rank."""
    scores = lightglue_scores_sp(mesh, params, kpts0_px, valid0, desc0,
                                 kpts1_px, valid1, desc1, n_layers,
                                 num_heads)
    return filter_matches(scores, valid0, valid1, filter_threshold)
