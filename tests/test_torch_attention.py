"""Kernel E's plain twin (ops/attention.py `fused_attention`) vs the JAX
Pallas kernel in interpret mode and the JAX dense attention (CPU).

Tolerance 1e-5 absolute and relative: both sides are f32 and differ only
in summation order. The routing tests check that CPU tensors take the
plain twin and never build the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models.lightglue import _attention as jax_dense
from keypoint_bench_tpu.ops.pallas_attention import \
    fused_attention as jax_fused
from keypoint_bench_tpu_torch.ops import _build, cuda_attention
from keypoint_bench_tpu_torch.ops.attention import fused_attention


def _case(h, n, m, dh, seed, valid="mixed"):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (h, r, dh)).astype(np.float32)
               for r in (n, m, m))
    if valid == "mixed":
        kv = rng.random(m) > 0.3
    else:
        kv = np.full(m, valid == "all")
    return q, k, v, kv


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("valid", ["mixed", "none"])
@pytest.mark.parametrize("scale", [None, 1.0])
def test_plain_twin_matches_pallas_interpret(valid, scale):
    q, k, v, kv = _case(4, 300, 420, 64, 0, valid)
    ref = jax_fused(*map(jnp.asarray, (q, k, v, kv)), scale=scale,
                    interpret=True)
    got = fused_attention(*map(torch.from_numpy, (q, k, v, kv)), scale)
    _close(got.numpy(), np.asarray(ref))
    if valid == "none":
        # all keys masked: uniform over the m real keys, finite
        _close(got.numpy(), np.broadcast_to(v.mean(1, keepdims=True),
                                            got.shape))


def test_plain_twin_matches_dense_and_broadcasts_the_mask():
    """Leading batch dims [B, h]; a mask [B, 1, m] broadcast over heads."""
    q, k, v, _ = _case(8, 50, 70, 64, 1)
    q, k, v = (x.reshape(2, 4, *x.shape[1:]) for x in (q, k, v))
    kv = np.random.default_rng(2).random((2, 70)) > 0.5
    got = fused_attention(*map(torch.from_numpy, (q, k, v)),
                          torch.from_numpy(kv)[:, None])
    for b in range(2):
        ref = jax_dense(*map(jnp.asarray, (q[b], k[b], v[b], kv[b])))
        _close(got[b].numpy(), np.asarray(ref))


def test_cpu_tensors_take_the_plain_twin(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda name: 1 / 0)
    monkeypatch.setattr(cuda_attention.KERNEL, "_fn", None)
    before = cuda_attention.KERNEL.launches
    args = [torch.from_numpy(x) for x in _case(2, 10, 12, 64, 3)]
    assert torch.equal(cuda_attention.masked_attention(*args, 1.0),
                       fused_attention(*args, 1.0))
    assert cuda_attention.KERNEL.launches == before


# --- the kernel's tiling, rehearsed in plain torch -------------------------

LOG2E = 1.4426950408889634


def tiled_online_softmax(q, k, v, kv, scale, bq, bk, tx):
    """csrc/attention.cu step by step for one slice, in f32: query tiles of
    bq rows, key tiles of bk whose rows past m repeat the last real key and
    score -inf, scores in base 2 (one factor scale * log2 e), masked keys at
    -1e9 * log2 e, a running row maximum that starts at -inf, the row sum
    kept apart for each of the tx lanes (lane t holds keys t, t + tx, ...)
    and added up at the end, the output rescaled by exp2(old max - new)."""
    n, m = q.shape[0], k.shape[0]
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    neg2 = torch.tensor(-1e9, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    out = torch.empty_like(q)
    for q0 in range(0, n, bq):
        rows = torch.arange(q0, q0 + bq).clamp_max(n - 1)
        qt = q[rows]
        mrow = torch.full((bq,), -torch.inf)
        lrow = torch.zeros((bq, tx))
        o = torch.zeros((bq, q.shape[1]))
        for j0 in range(0, m, bk):
            cols = torch.arange(j0, j0 + bk)
            real = cols < m
            cols = cols.clamp_max(m - 1)
            s = (qt @ k[cols].T) * scale2
            s = torch.where(kv[cols], s, neg2)
            s = torch.where(real, s, torch.tensor(-torch.inf))
            mnew = torch.maximum(mrow, s.amax(-1))
            alpha = torch.exp2(mrow - mnew)
            p = torch.exp2(s - mnew[:, None])
            # lane t of a row adds its own keys t, t + tx, ... in order
            lrow = lrow * alpha[:, None] + p.reshape(bq, bk // tx, tx).sum(1)
            o = o * alpha[:, None] + p @ v[cols]
            mrow = mnew
        res = o / lrow.sum(-1, keepdim=True)
        out[q0:min(q0 + bq, n)] = res[:min(bq, n - q0)]
    return out


@pytest.mark.parametrize("n,m,valid,scale", [
    (300, 420, "mixed", None),      # ragged in both, several key tiles
    (300, 420, "mixed", 1.0),
    (257, 33, "mixed", None),       # m below one key tile, n one past a tile
    (40, 64, "mixed", 1.0),         # exactly one key tile
    (70, 65, "none", None),         # all keys invalid: uniform over m
    (1, 1, "all", None),
])
def test_tiled_online_softmax_matches_plain_and_pallas(n, m, valid, scale):
    """The kernel's tiling at its tile sizes, against the plain twin and the
    JAX Pallas kernel (interpret mode): 1e-5 absolute and relative, f32
    sums in another order."""
    q, k, v, kv = _case(2, n, m, 64, n + m, valid)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkv = torch.from_numpy(kv)
    sc = 64 ** -0.5 if scale is None else scale
    got = torch.stack([tiled_online_softmax(
        tq[h], tk[h], tv[h], tkv, sc, cuda_attention.BQ, cuda_attention.BK, 8)
        for h in range(2)])
    assert bool(torch.isfinite(got).all())
    _close(got.numpy(), fused_attention(tq, tk, tv, tkv, scale).numpy())
    ref = jax_fused(*map(jnp.asarray, (q, k, v, kv)), scale=scale,
                    interpret=True)
    _close(got.numpy(), np.asarray(ref))
    if valid == "none":
        _close(got.numpy(), np.broadcast_to(v.mean(1, keepdims=True),
                                            got.shape))


def test_head_mask_is_the_broadcast_mask_made_once():
    """`head_mask` is what `masked_attention` would broadcast for itself:
    same result, contiguous, one byte per key."""
    q, k, v, _ = _case(8, 20, 30, 64, 5)
    q, k, v = (torch.from_numpy(x.reshape(2, 4, *x.shape[1:]))
               for x in (q, k, v))
    kv = torch.from_numpy(np.random.default_rng(6).random((2, 30)) > 0.5)
    hm = cuda_attention.head_mask(kv, 4)
    assert hm.shape == (2, 4, 30) and hm.is_contiguous()
    assert hm.dtype == torch.bool and hm.element_size() == 1
    assert torch.equal(cuda_attention.masked_attention(q, k, v, hm),
                       fused_attention(q, k, v, kv[:, None]))
