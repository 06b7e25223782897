"""The fundamental-matrix task, its RANSAC, the SE3 helpers and the
synthetic sequences in the PyTorch port vs the JAX reference (CPU).

Tolerances:
  * `epipolar_errors`: rtol 1e-5 and 1e-4 px absolute: x1^T F x0 is a sum
    of three terms of some hundred units each that cancel to a fraction of
    a pixel, so float32 summation order shows at about 2e-5 px;
    `fundamental_metrics`: mean error and ratio rtol 1e-5, hit count equal;
  * `pose_to_fundamental`, `_fundamentals_from_poses` and both synthetic
    sequence datasets are numpy on both sides: bit-equal;
  * `ransac_fundamental_from_samples`, fed the minimal samples that JAX's
    `_sample_minimal` draws from the same key: inliers and ok equal, F
    (scaled to unit Frobenius norm and a common sign) within 1e-3
    absolute (measured: 1e-7 to 4e-5). Hypotheses are solved on
    Hartley-normalized points, where A^T A is well conditioned, so both
    sides pick the same consensus set whenever it is unambiguous; the
    refit's F differs by what the two LAPACK SVDs differ in float32. The
    seeds are ones with an unambiguous consensus set: on seed 1 of this
    generator two hypotheses are within one inlier of each other, the
    sides pick different winners and the refits differ by 0.13.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.datasets import sequences as jseq
from keypoint_bench_tpu.datasets import synthetic as jsyn
from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.geometry import se3 as jse3
from keypoint_bench_tpu.tasks import fundamental as jf
from keypoint_bench_tpu_torch.datasets import get_dataset, sequences as tseq
from keypoint_bench_tpu_torch.datasets import synthetic as tsyn
from keypoint_bench_tpu_torch.datasets.registry import register_preloaded
from keypoint_bench_tpu_torch.geometry import ransac as tr
from keypoint_bench_tpu_torch.geometry import se3 as tse3
from keypoint_bench_tpu_torch.tasks import fundamental as tf


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 256.0
K = np.array([[230.0, 0, S / 2], [0, 230.0, S / 2], [0, 0, 1]])


def _pose(seed):
    import cv2
    rng = np.random.default_rng(seed)
    T = np.eye(4)
    T[:3, :3] = cv2.Rodrigues(rng.normal(0, 0.05, 3))[0]
    T[:3, 3] = [rng.uniform(0.3, 0.7), rng.uniform(-0.2, 0.2),
                rng.uniform(-0.1, 0.1)]
    return T


def _scene(seed, k=150, outliers=0.25, noise=0.2):
    """Pixel correspondences of 3D points in general position seen from
    two cameras, with noise, gross outliers (20 to 60 px off in a random
    direction) and invalid rows; the true F (x1^T F x0 = 0)."""
    rng = np.random.default_rng(seed)
    T = _pose(seed)
    X = np.c_[rng.uniform(-3, 3, (k, 2)), rng.uniform(4, 12, k)]
    x0 = X @ K.T
    X1 = X @ T[:3, :3].T + T[:3, 3]
    x1 = X1 @ K.T
    p0 = x0[:, :2] / x0[:, 2:]
    p1 = x1[:, :2] / x1[:, 2:] + rng.normal(0, noise, (k, 2))
    F = tse3.pose_to_fundamental(T, K, K)
    bad = rng.random(k) < outliers
    ang = rng.uniform(0, 2 * np.pi, bad.sum())
    p1[bad] += rng.uniform(20, 60, bad.sum())[:, None] * np.c_[np.cos(ang),
                                                               np.sin(ang)]
    mask = rng.random(k) > 0.1
    return p0.astype(np.float32), p1.astype(np.float32), mask, \
        F.astype(np.float32), bad


def _unit(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.abs(F).argmax()])


@pytest.mark.parametrize("seed", [0, 1])
def test_epipolar_errors_and_metrics_match_jax(seed):
    p0, p1, mask, F, _ = _scene(seed)
    args_j = tuple(map(jnp.asarray, (p0, p1, mask, F)))
    args_t = tuple(map(torch.from_numpy, (p0, p1, mask, F)))
    err, m = tf.epipolar_errors(*args_t)
    jerr, _ = jf.epipolar_errors(*args_j)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(m.numpy(), mask)
    for th in (1.0, 3.0):
        got = tf.fundamental_metrics(*args_t, th)
        want = jf.fundamental_metrics(*args_j, th)
        assert int(got["fundamental_num"]) == int(want["fundamental_num"])
        for key in ("fundamental_error", "fundamental_radio"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5)


def test_metrics_batched_equal_per_pair_and_empty_mask():
    cases = [_scene(s) for s in (2, 3)]
    stack = [torch.from_numpy(np.stack([c[i] for c in cases]))
             for i in range(4)]
    out = tf.fundamental_metrics(*stack, 3.0)
    for b, c in enumerate(cases):
        one = tf.fundamental_metrics(*map(torch.from_numpy, c[:4]), 3.0)
        for key in one:
            assert torch.equal(out[key][b], one[key])
    p0, p1, mask, F, _ = cases[0]
    none = tf.fundamental_metrics(*map(torch.from_numpy,
                                       (p0, p1, np.zeros_like(mask), F)))
    # the mean divides by max(number of valid entries, 1)
    assert float(none["fundamental_error"]) == 0.0
    assert int(none["fundamental_num"]) == 0


def test_se3_helpers_equal_jax_package():
    T = _pose(4)
    np.testing.assert_array_equal(tse3.inv_T(T), jse3.inv_T(T))
    np.testing.assert_array_equal(tse3.skew(T[:3, 3]), jse3.skew(T[:3, 3]))
    np.testing.assert_array_equal(tse3.pose_to_fundamental(T, K, K),
                                  jse3.pose_to_fundamental(T, K, K))
    Ts = [_pose(s) for s in range(4)]
    np.testing.assert_array_equal(
        tseq._fundamentals_from_poses(Ts, 230.0, 231.0, 128.0, 120.0),
        jseq._fundamentals_from_poses(Ts, 230.0, 231.0, 128.0, 120.0))


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], str):
            assert a[key] == b[key]
        else:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


@pytest.mark.parametrize("name,kw", [
    ("SyntheticSequenceDataset", dict(num_frames=4, image_size=64, seed=3)),
    ("SyntheticSplatSequenceDataset", dict(num_frames=3, image_size=64,
                                           seed=2, n_blobs=60))])
def test_synthetic_sequences_equal_jax_package(name, kw):
    got = getattr(tsyn, name)(**kw)
    want = getattr(jsyn, name)(**kw)
    assert len(got) == len(want)
    for i in range(len(got)):
        _assert_items_equal(got[i], want[i])


def test_registry_sequence_types_and_preloaded():
    ds = get_dataset({"type": "synthetic_sequence", "num_frames": 3,
                      "image_size": 64, "seed": 1})
    assert len(ds) == 3 and ds[1]["fundamental"].shape == (3, 3)
    sp = get_dataset({"type": "synthetic_splat_sequence", "num_frames": 2,
                      "image_size": 64})
    assert len(sp) == 2 and sp[0]["image0"].shape == (64, 64, 3)
    register_preloaded("torch_fund_items", [ds[0], ds[1]])
    pre = get_dataset({"type": "preloaded", "name": "torch_fund_items"})
    assert len(pre) == 2
    np.testing.assert_array_equal(pre[1]["fundamental"], ds.Fs[1])
    with pytest.raises(ValueError):
        tsyn.SyntheticSequenceDataset(num_frames=400, image_size=64)
    # the file-backed types are ported: a missing ground-truth file raises
    # FileNotFoundError, as the JAX package's loader does
    with pytest.raises(FileNotFoundError):
        get_dataset({"type": "tartanair", "root": "x", "gt": "y"})


@pytest.mark.parametrize("seed", [0, 2, 3, 4, 5])
def test_ransac_fundamental_from_jax_samples_matches_jax(seed):
    p0, p1, mask, F_true, bad = _scene(seed)
    key = jax.random.key(seed)
    F_ref, inl_ref, ok_ref = jr.ransac_fundamental(
        *map(jnp.asarray, (p0, p1, mask)), key, n_hyp=256)
    idx = np.array(jr._sample_minimal(key, jnp.asarray(mask), 256, 8))
    F, inl, ok = tr.ransac_fundamental_from_samples(
        *map(torch.from_numpy, (p0, p1, mask, idx)))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_ref))
    assert bool(ok) == bool(ok_ref) is True
    np.testing.assert_allclose(_unit(F.numpy()), _unit(F_ref), atol=1e-3)
    # the consensus set is the clean correspondences, plus the few
    # outliers that lie along their epipolar lines
    assert (inl.numpy() & ~bad).sum() >= 0.95 * (mask & ~bad).sum()
    assert (inl.numpy() & bad).sum() <= 0.25 * (mask & bad).sum()
    clean = torch.from_numpy(mask & ~bad)
    err, _ = tf.epipolar_errors(torch.from_numpy(p0), torch.from_numpy(p1),
                                clean, F)
    assert float(err[clean].mean()) < 1.0          # pixels; noise is 0.2


def test_ransac_fundamental_batched_and_generator():
    cases = [_scene(s) for s in (3, 4)]
    stack = [torch.from_numpy(np.stack([c[i] for c in cases]))
             for i in range(3)]
    idx = tr._sample_minimal(stack[2], 64, 8,
                             torch.Generator().manual_seed(1))
    assert idx.shape == (2, 64, 8)
    F, inl, ok = tr.ransac_fundamental_from_samples(*stack, idx)
    for b, c in enumerate(cases):
        F1, inl1, ok1 = tr.ransac_fundamental_from_samples(
            *map(torch.from_numpy, c[:3]), idx[b])
        np.testing.assert_allclose(F[b].numpy(), F1.numpy(), atol=1e-6)
        assert torch.equal(inl[b], inl1) and bool(ok[b]) == bool(ok1)
    a = tr.ransac_fundamental(*stack, torch.Generator().manual_seed(5),
                              n_hyp=64)
    b = tr.ransac_fundamental(*stack, torch.Generator().manual_seed(5),
                              n_hyp=64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_fundamental_ransac_ratio():
    p0, p1, mask, _, bad = _scene(5)
    args = tuple(map(torch.from_numpy, (p0, p1, mask)))
    out = tf.fundamental_ransac_ratio(*args,
                                      torch.Generator().manual_seed(0), 256)
    clean = (mask & ~bad).sum() / mask.sum()
    assert abs(float(out["fundamental_radio"]) - clean) < 0.08
    assert int(out["fundamental_num"]) == round(
        float(out["fundamental_radio"]) * mask.sum())
    want = jf.fundamental_ransac_ratio(*map(jnp.asarray, (p0, p1, mask)),
                                       jax.random.key(0), 256)
    assert abs(float(out["fundamental_radio"])
               - float(want["fundamental_radio"])) < 0.05
    few = mask.copy()
    few[7:] = False
    out = tf.fundamental_ransac_ratio(
        *map(torch.from_numpy, (p0, p1, few)),
        torch.Generator().manual_seed(0), 64)
    assert float(out["fundamental_radio"]) == 0.0       # fewer than 8: not ok
