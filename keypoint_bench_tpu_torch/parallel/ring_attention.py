"""Ring attention over the mesh's 'data' ranks (counterpart of
keypoint_bench_tpu/parallel/ring_attention.py): the sequence-parallel
primitive.

Each rank keeps its block of the queries; the key / value chunks and
their mask go round the ring (`Mesh.ring_shift`, jax.lax.ppermute with
[(i, i + 1 mod n)]) while the softmax accumulates online, with a running
max, a running denominator and a rescaled accumulator, so a K-token
attention holds K / n keys on a rank at a time. The body is the JAX
shard's step for step: the -1e30 mask value and initial max, the
correction exp(run_max - new_max), n steps each followed by the ring hop
of k, v and the mask, and acc / max(denom, 1e-30) at the end. That makes
a rank whose whole chunk is masked come out right, and a row with no
valid key the uniform average, as the dense softmax gives it.

As in the JAX package the products are plain matmuls outside any
kernel. LightGlue at its benchmark sizes (K <= 2k) does not need this:
it is the scaling path for very large keypoint sets.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.parallel.mesh import Mesh

_AXIS = "data"
_NEG = -1e30


def _ring_attention_shard(mesh: Mesh, q, k, v, kv_valid):
    """One rank's body: q [h, nq, d]; k / v [h, nk, d]; kv_valid [nk],
    this rank's blocks. Online-softmax accumulation over the ring-rotated
    key / value chunks; returns [h, nq, d]."""
    n_shards = mesh.n_data
    scale = q.shape[-1] ** -0.5
    h, nq, d = q.shape
    acc = torch.zeros((h, nq, d), dtype=torch.float32, device=q.device)
    denom = torch.zeros((h, nq), dtype=torch.float32, device=q.device)
    run_max = torch.full((h, nq), _NEG, dtype=torch.float32, device=q.device)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=q.device)
    k_c, v_c, m_c = k, v, kv_valid
    for _ in range(n_shards):
        sim = (q @ k_c.transpose(-1, -2)) * scale
        sim = torch.where(m_c[None, None, :], sim, neg)
        chunk_max = sim.amax(-1)                             # [h, nq]
        new_max = torch.maximum(run_max, chunk_max)
        correction = torch.exp(run_max - new_max)
        p = torch.exp(sim - new_max[..., None])              # [h, nq, nk]
        acc = acc * correction[..., None] + p @ v_c
        denom = denom * correction + p.sum(-1)
        run_max = new_max
        # rotate the chunk to the next rank on the ring
        k_c = mesh.ring_shift(k_c, _AXIS)
        v_c = mesh.ring_shift(v_c, _AXIS)
        m_c = mesh.ring_shift(m_c, _AXIS)
    return acc / torch.clamp_min(denom, 1e-30)[..., None]


def row_block(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This data rank's contiguous block of x along `dim` (JAX's
    PartitionSpec over 'data'); raises ValueError where the data ranks do
    not divide it."""
    n, size = mesh.n_data, x.shape[dim]
    if size % n:
        raise ValueError(f"{n} data ranks do not divide {size} rows")
    b = size // n
    return x.narrow(dim, mesh.data_rank * b, b)


def gather_rows(mesh: Mesh, block: torch.Tensor, dim: int) -> torch.Tensor:
    """The data ranks' blocks joined along `dim` in rank order, on every
    rank (the whole of what `row_block` split)."""
    return torch.cat(mesh.all_gather(block, _AXIS), dim=dim)


@torch.inference_mode()
def ring_attention(mesh: Mesh, q, k, v, kv_valid):
    """Sequence-parallel attention: q [h, NQ, d], k / v [h, NK, d] and
    kv_valid [NK], the whole sets on every rank; each data rank attends
    with its contiguous block of NQ over the ring of NK blocks and returns
    its block of the output, [h, NQ / n, d] (`gather_rows(mesh, out, 1)`
    joins them). Equals `dense_attention`. Raises ValueError where the
    'data' size does not divide NQ or NK."""
    return _ring_attention_shard(
        mesh, row_block(mesh, q, 1), row_block(mesh, k, 1),
        row_block(mesh, v, 1), row_block(mesh, kv_valid, 0))


def dense_attention(q, k, v, kv_valid):
    """The plain reference: masked softmax attention over the whole sets."""
    scale = q.shape[-1] ** -0.5
    sim = (q @ k.transpose(-1, -2)) * scale
    sim = torch.where(kv_valid[None, None, :], sim,
                      torch.tensor(_NEG, dtype=sim.dtype, device=sim.device))
    return torch.softmax(sim, dim=-1) @ v
