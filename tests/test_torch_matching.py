"""Matching in the PyTorch port vs the JAX reference (CPU).

Indices and masks must be equal. Descriptors are small integers, so every
squared distance is exact in f32 on both sides and ties are real ties
(first index wins); the random-float case compares distances at rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ops import matching as jm
from keypoint_bench_tpu_torch.ops import matching as tm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    m, n, d = 40, 50, 8
    a = rng.integers(-3, 4, (m, d)).astype(np.float32)
    b = rng.integers(-3, 4, (n, d)).astype(np.float32)
    va = np.ones(m, bool)
    vb = np.ones(n, bool)
    if kind == "ties":
        b[10:20] = b[0:10]          # duplicate rows: first index must win
        a[5:15] = b[0:10]
    elif kind == "invalid":
        va[::3] = False
        vb[::4] = False
        a[0] = b[0]                 # an exact match on an invalid row
    return a, b, va, vb


@pytest.mark.parametrize("kind", ["plain", "ties", "invalid"])
@pytest.mark.parametrize("max_distance", [2.5, 5.0, float("inf")])
def test_mutual_nn_match_matches_jax(kind, max_distance):
    a, b, va, vb = _case(kind, 1)
    nn_ref, ok_ref = jm.mutual_nn_match(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(va), jnp.asarray(vb),
                                        max_distance)
    nn, ok = tm.mutual_nn_match(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(va), torch.from_numpy(vb),
                                max_distance)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(nn_ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert 0 < int(ok.sum()) < len(a) or max_distance == 2.5


def test_batched_match_equals_per_pair():
    cases = [_case(k, s) for k, s in (("plain", 2), ("ties", 3))]
    stack = [torch.from_numpy(np.stack([c[i] for c in cases]))
             for i in range(4)]
    nn, ok = tm.mutual_nn_match(*stack, 5.0)
    for i, c in enumerate(cases):
        nn_i, ok_i = tm.mutual_nn_match(*map(torch.from_numpy, c), 5.0)
        np.testing.assert_array_equal(nn[i].numpy(), nn_i.numpy())
        np.testing.assert_array_equal(ok[i].numpy(), ok_i.numpy())


def test_pairwise_sqdist_and_take_rows():
    rng = np.random.default_rng(4)
    a = rng.random((30, 64), np.float32)
    b = rng.random((20, 64), np.float32)
    np.testing.assert_allclose(
        tm.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jm.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    idx = rng.integers(0, 20, 30)
    np.testing.assert_array_equal(
        tm.take_rows(torch.from_numpy(b), torch.from_numpy(idx)).numpy(),
        np.asarray(jm.take_rows(jnp.asarray(b), jnp.asarray(idx))))


def test_brute_force_match_matches_jax():
    rng = np.random.default_rng(5)
    h, w, k = 24, 32, 60
    maps = [np.round(rng.random((h, w, 8)) * 4).astype(np.float32)
            for _ in range(2)]
    # keypoints on pixel centres of the (w-1, h-1) grid: exact samples
    kp = [np.stack([rng.integers(0, w, k) / (w - 1.0),
                    rng.integers(0, h, k) / (h - 1.0),
                    rng.random(k)], -1).astype(np.float32) for _ in range(2)]
    kp[1][:20] = kp[0][:20]
    maps[1] = maps[0].copy()
    valid = [rng.random(k) > 0.2 for _ in range(2)]
    ref = jm.brute_force_match(*(jnp.asarray(x) for x in
                                 (kp[0], valid[0], kp[1], valid[1],
                                  maps[0], maps[1])), 1.0)
    got = tm.brute_force_match(*(torch.from_numpy(x) for x in
                                 (kp[0], valid[0], kp[1], valid[1],
                                  maps[0], maps[1])), 1.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[2].sum()) > 0
