"""Tensor-parallel LightGlue: the attention heads split over the mesh's
'model' ranks (counterpart of keypoint_bench_tpu/parallel/lightglue_tp.py;
Megatron-style).

Each model rank holds num_heads / n heads: its block of the rows of the
Wqkv, to_qk and to_v projections (their outputs are laid out head by
head) and the matching block of the columns of out_proj and to_out. It
attends over the full keypoint sets with its heads, through the port's
attention router (`masked_attention`: kernel E on CUDA, at [.., num_heads
/ n, K, 64]), and the output projections' partial products are summed
over the ranks by one all_reduce each, the bias added after. The FFNs,
the positional encoding and the assignment head stay whole on every rank.
The result is the dense `lightglue_forward`'s up to float summation
order.
"""
from __future__ import annotations

import torch.nn.functional as F

from keypoint_bench_tpu_torch.models.lightglue import (filter_matches,
                                                       lightglue_scores)
from keypoint_bench_tpu_torch.parallel.mesh import Mesh

_ROW_SPLIT = (".self_attn.Wqkv.", ".cross_attn.to_qk.", ".cross_attn.to_v.")
_COL_SPLIT = (".self_attn.out_proj.weight", ".cross_attn.to_out.weight")


def _rows(name: str) -> bool:
    return any(s in name for s in _ROW_SPLIT)


def _cols(name: str) -> bool:
    return any(name.endswith(s) for s in _COL_SPLIT)


def shard_lightglue_params(params: dict, n_shards: int,
                           num_heads: int = 4) -> dict:
    """The torch-layout params with each attention projection split into
    n_shards head blocks along a new leading axis (the rows of Wqkv,
    to_qk, to_v and their biases; the columns of out_proj and to_out);
    everything else as it is."""
    if num_heads % n_shards:
        raise ValueError(f"{n_shards} shards do not split {num_heads} "
                         f"heads")
    out = {}
    for k, v in params.items():
        if _rows(k):
            v = v.reshape(n_shards, v.shape[0] // n_shards, *v.shape[1:])
        elif _cols(k):
            v = v.reshape(v.shape[0], n_shards,
                          v.shape[1] // n_shards).transpose(0, 1)
        out[k] = v.contiguous()
    return out


def lightglue_forward_tp(mesh: Mesh, sharded_params: dict, kpts0_px,
                         valid0, desc0, kpts1_px, valid1, desc1,
                         n_layers: int = 9, num_heads: int = 4,
                         filter_threshold: float = 0.1, attn: str = "auto"):
    """Head-sharded `lightglue_forward` over the mesh's 'model' ranks
    (sharded_params from `shard_lightglue_params(params,
    mesh.n_model)`; every model rank passes the same inputs). Returns (m0,
    mscores0, match_mask) as `lightglue_forward`, on every rank."""
    n = mesh.n_model
    if num_heads % n:
        raise ValueError(f"{n} model ranks do not split {num_heads} heads")
    r = mesh.model_rank
    p = {k: (v[r] if _rows(k) or _cols(k) else v)
         for k, v in sharded_params.items()}

    def out(p, name, x):
        """This rank's heads' part of the projection, summed over the
        model ranks, then the bias."""
        part = F.linear(x, p[f"{name}.weight"])
        return mesh.all_reduce(part, "model") + p[f"{name}.bias"]

    scores = lightglue_scores(p, kpts0_px, valid0, desc0, kpts1_px, valid1,
                              desc1, n_layers, num_heads // n, attn, out)
    return filter_matches(scores, valid0, valid1, filter_threshold)
