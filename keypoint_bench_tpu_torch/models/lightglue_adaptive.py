"""Adaptive LightGlue: depth early exit and width pruning (counterpart of
keypoint_bench_tpu/models/lightglue_adaptive.py; reference
models/lightglue.py:561-589, 653-679, its default mode with
depth_confidence 0.95 and width_confidence 0.99).

After every layer but the last, each side's token confidence (a sigmoid
of `token_confidence.<i>`) is compared with the layer's threshold
0.8 + 0.1 exp(-4 i / L): the matcher stops once the share of confident
tokens among the originally valid ones exceeds depth_confidence, and
otherwise prunes the tokens that are confident (c > th) and unmatchable
(matchability <= 1 - width_confidence). Pruning only shrinks the
validity masks, as the JAX package does: shapes stay fixed and pruned
tokens stay in the tensors, outside every softmax. The assignment head
of the last layer run scores the pruned masks.

Stopping is data-dependent, so the layer loop is a Python loop that
reads `stop` on the host once a layer (the reference does the same); one
pair at a time, no leading batch dimensions. In the "fused" form kernel
E's per-head masks are rebuilt from the current masks at every layer.
"""
from __future__ import annotations

import numpy as np
import torch

from keypoint_bench_tpu_torch.models.lightglue import (
    _assignment_scores, _cross_block, _linear, _posenc, _self_block,
    filter_matches, normalize_keypoints_masked, resolve_attn)
from keypoint_bench_tpu_torch.ops.cuda_attention import head_mask


def conf_thresholds(n_layers: int) -> list[float]:
    """lightglue.py:653-656: 0.8 + 0.1 exp(-4 i / L), clipped to [0, 1],
    as the float32 values the JAX package compares with."""
    i = np.arange(n_layers)
    th = np.clip(0.8 + 0.1 * np.exp(-4.0 * i / n_layers), 0, 1)
    return [float(t) for t in th.astype(np.float32)]


def _masks(a0, a1, same: bool, fused: bool, num_heads: int):
    """The attention masks of one layer: (self mask of side 0 or of both
    sides stacked, self mask of side 1 or None, cross masks m0, m1, m10)
    in the form `_self_block` / `_cross_block` take them."""
    if same:
        m01 = torch.stack([a0, a1])
        m10 = torch.stack([a1, a0])
        if fused:
            return (head_mask(m01, num_heads), None, a0, a1,
                    head_mask(m10, num_heads))
        return m01, None, a0, a1, None
    if fused:
        a0, a1 = head_mask(a0, num_heads), head_mask(a1, num_heads)
    return a0, a1, a0, a1, None


def _margin(x: torch.Tensor, th: float, valid: torch.Tensor) -> torch.Tensor:
    """The smallest |x - th| over the valid entries (inf where none)."""
    d = (x - th).abs()
    return torch.where(valid, d, torch.full_like(d, float("inf"))).amin()


@torch.inference_mode()
def lightglue_forward_adaptive(params: dict, kpts0_px, valid0, desc0,
                               kpts1_px, valid1, desc1, n_layers: int = 9,
                               num_heads: int = 4,
                               filter_threshold: float = 0.1,
                               depth_confidence: float = 0.95,
                               width_confidence: float = 0.99,
                               attn: str = "auto",
                               stats: dict | None = None):
    """One pair: kpts*_px [K, 2] pixel coordinates, valid* [K] bool, desc*
    [K, input_dim]. Returns (m0 [K0] index into set 1 or -1, mscores0
    [K0], match_mask [K0], i_fin), i_fin the number of layers run.

    `stats`, when given, receives per layer the masks' counts after the
    layer ("keep": (n0, n1) device tensors), the smallest distance of any
    compared value from its threshold ("margin": the valid tokens'
    confidences and matchabilities, and the confident share; a device
    scalar a layer that decides), the compared values themselves
    ("values": (c0, c1, z0, z1, confident share, a0, a1) a layer that
    decides, a0 / a1 the masks it decides over), the last masks and the
    log assignment scores the matches are filtered from ("masks",
    "scores"), and the host reads of `stop` ("syncs"); a check in another
    precision holds the values and scores against its own."""
    attn = resolve_attn(attn, desc0.device)
    p = params
    if "input_proj.weight" in p:
        desc0 = _linear(p, "input_proj", desc0)
        desc1 = _linear(p, "input_proj", desc1)
    enc0 = _posenc(p, normalize_keypoints_masked(kpts0_px, valid0))
    enc1 = _posenc(p, normalize_keypoints_masked(kpts1_px, valid1))
    same = desc0.shape == desc1.shape
    fused = attn == "fused"
    enc01 = torch.stack([enc0, enc1], dim=1) if same else None
    ths = conf_thresholds(n_layers)
    m_count = (valid0.sum() + valid1.sum()).clamp_min(1).float()
    unmatchable = 1 - width_confidence
    if stats is not None:
        stats.update(keep=[], margin=[], values=[], syncs=0)

    d0, d1, a0, a1 = desc0, desc1, valid0, valid1
    i_fin = n_layers
    for i in range(n_layers):
        pre = f"transformers.{i}"
        s0, s1, m0, m1, m10 = _masks(a0, a1, same, fused, num_heads)
        if same:
            d01 = _self_block(p, f"{pre}.self_attn", torch.stack([d0, d1]),
                              enc01, s0, num_heads, attn)
            d0, d1 = d01[0], d01[1]
        else:
            d0 = _self_block(p, f"{pre}.self_attn", d0, enc0, s0, num_heads,
                             attn)
            d1 = _self_block(p, f"{pre}.self_attn", d1, enc1, s1, num_heads,
                             attn)
        d0, d1 = _cross_block(p, f"{pre}.cross_attn", d0, d1, m0, m1,
                              num_heads, attn, m10)
        if i == n_layers - 1:
            # the last layer ends the loop whatever its confidences
            if stats is not None:
                stats["keep"].append((a0.sum(), a1.sum()))
            break
        th = ths[i]
        c0 = torch.sigmoid(_linear(p, f"token_confidence.{i}.token.0",
                                   d0))[:, 0]
        c1 = torch.sigmoid(_linear(p, f"token_confidence.{i}.token.0",
                                   d1))[:, 0]
        n_low = ((c0 < th) & a0).sum() + ((c1 < th) & a1).sum()
        ratio = 1.0 - n_low.float() / m_count
        stop = ratio > depth_confidence
        z0 = torch.sigmoid(_linear(p, f"log_assignment.{i}.matchability",
                                   d0))[:, 0]
        z1 = torch.sigmoid(_linear(p, f"log_assignment.{i}.matchability",
                                   d1))[:, 0]
        if stats is not None:
            gaps = [_margin(c0, th, a0), _margin(c1, th, a1),
                    (ratio - depth_confidence).abs()]
            if 0 <= unmatchable < 1:     # else no sigmoid decides it
                gaps += [_margin(z0, unmatchable, a0),
                         _margin(z1, unmatchable, a1)]
            stats["margin"].append(torch.stack(gaps).amin())
            stats["values"].append((c0, c1, z0, z1, ratio, a0, a1))
            stats["syncs"] += 1
        if bool(stop):
            if stats is not None:
                stats["keep"].append((a0.sum(), a1.sum()))
            i_fin = i + 1
            break
        a0 = a0 & ((z0 > unmatchable) | (c0 <= th))
        a1 = a1 & ((z1 > unmatchable) | (c1 <= th))
        if stats is not None:
            stats["keep"].append((a0.sum(), a1.sum()))

    scores = _assignment_scores(p, f"log_assignment.{i_fin - 1}", d0, d1,
                                a0, a1)
    if stats is not None:
        stats.update(masks=(a0, a1), scores=scores)
    return (*filter_matches(scores, a0, a1, filter_threshold), i_fin)
