"""RANSAC-H and MHA in the PyTorch port vs the JAX reference (CPU).

torch's and JAX's random streams differ, so the port's RANSAC is fed the
minimal samples that JAX's `_sample_minimal` draws from the same key.
Tolerances: H within rtol 1e-4 (atol 1e-6) after H[2,2] normalization,
inliers and ok equal, MHA hits equal. Both sides solve in f32 through
LAPACK's SVD of A^T A; the refit is Hartley-normalized and agrees to
about 1e-6 once both sides pick the same consensus set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.tasks.mha import mha_pair as jax_mha_pair
from keypoint_bench_tpu_torch.geometry import ransac as tr
from keypoint_bench_tpu_torch.tasks.mha import mha_pair


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 256.0


def _H(seed):
    rng = np.random.default_rng(seed)
    ang, sc = rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.1)
    tx, ty = rng.uniform(-20, 20, 2)
    c, s = np.cos(ang) * sc, np.sin(ang) * sc
    T = np.array([[1, 0, S / 2], [0, 1, S / 2], [0, 0, 1]])
    R = np.array([[c, -s, tx], [s, c, ty], [1e-4, -2e-4, 1]])
    return (T @ R @ np.linalg.inv(T)).astype(np.float32)


def _matches(seed, k=120, outliers=0.3, noise=0.3):
    """Normalized matched keypoints under a homography, with noise,
    outliers and invalid rows. An outlier lies 15 to 40 pixels off its true
    match and an inlier within a pixel, so every hypothesis fit to inliers
    alone finds the same consensus set: raw-pixel DLT hypotheses in f32
    are accurate to rounding noise only (A^T A is ill-conditioned), and
    the two sides' LAPACK solves differ at that level."""
    rng = np.random.default_rng(seed)
    H = _H(seed)
    p0 = rng.uniform(5, S - 6, (k, 2))
    q = np.c_[p0, np.ones(k)] @ H.T.astype(np.float64)
    p1 = q[:, :2] / q[:, 2:] + rng.normal(0, noise, (k, 2))
    bad = rng.random(k) < outliers
    ang = rng.uniform(0, 2 * np.pi, bad.sum())
    p1[bad] += rng.uniform(15, 40, bad.sum())[:, None] * np.c_[np.cos(ang),
                                                               np.sin(ang)]
    mask = rng.random(k) > 0.1
    m0 = np.c_[p0 / (S - 1), rng.random(k)].astype(np.float32)
    m1 = np.c_[p1 / (S - 1), rng.random(k)].astype(np.float32)
    return m0, m1, mask, H


def _jax_idx(key, mask, n_hyp):
    return np.array(jr._sample_minimal(key, jnp.asarray(mask), n_hyp, 4))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_from_jax_samples_matches_jax(seed):
    m0, m1, mask, _ = _matches(seed)
    p0, p1 = m0[:, :2] * (S - 1), m1[:, :2] * (S - 1)
    key = jax.random.key(seed)
    H_ref, inl_ref, ok_ref = jr.ransac_homography(
        *map(jnp.asarray, (p0, p1, mask)), key, n_hyp=256)
    idx = _jax_idx(key, mask, 256)
    H, inl, ok = tr.ransac_homography_from_samples(
        *map(torch.from_numpy, (p0, p1, mask, idx)))
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_ref))
    assert bool(ok) == bool(ok_ref) is True


@pytest.mark.parametrize("seed", [3, 4])
def test_mha_pair_hits_match_jax(seed):
    m0, m1, mask, H = _matches(seed, noise=0.6)
    key = jax.random.key(seed)
    ths = (0.05, 0.2, 1.0, 7.0)
    ref = jax_mha_pair(*map(jnp.asarray, (m0, m1, mask, H)), S, S, S, S, key,
                       thresholds=ths, n_hyp=128)
    idx = _jax_idx(key, mask, 128)
    got = mha_pair(*map(torch.from_numpy, (m0, m1, mask, H)), S, S, S, S,
                   thresholds=ths, sample_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[-1] == 1.0


def test_too_few_matches_gives_no_hits():
    m0, m1, mask, H = _matches(5)
    mask[:] = False
    mask[:3] = True
    gen = torch.Generator().manual_seed(0)
    got = mha_pair(*map(torch.from_numpy, (m0, m1, mask, H)), S, S, S, S,
                   gen)
    assert got.tolist() == [0.0, 0.0, 0.0]


def test_batched_equals_per_pair_and_samples_are_distinct_valid():
    cases = [_matches(s) for s in (6, 7)]
    stack = [torch.from_numpy(np.stack([c[i] for c in cases]))
             for i in range(4)]
    idx = tr._sample_minimal(stack[2], 64, 4,
                             torch.Generator().manual_seed(1))
    assert idx.shape == (2, 64, 4)
    for b in range(2):
        ib = idx[b].numpy()
        assert (np.sort(ib, 1)[:, 1:] != np.sort(ib, 1)[:, :-1]).all()
        assert cases[b][2][ib].all()
    hits = mha_pair(*stack, S, S, S, S, sample_idx=idx)
    for b, c in enumerate(cases):
        one = mha_pair(*map(torch.from_numpy, c), S, S, S, S,
                       sample_idx=idx[b])
        assert torch.equal(hits[b], one)
