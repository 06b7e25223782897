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
