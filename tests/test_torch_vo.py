"""Monocular VO in the PyTorch port vs the JAX reference (CPU): ATE with
Umeyama alignment, the KITTI trajectory file, pose chaining and the
batched `vo_pair_pose`.

torch's and JAX's random streams differ, so the port is fed the minimal
samples that JAX's `_sample_minimal` draws from the same keys.

Tolerances and what limits them:
  - `umeyama_align` and `ate_rmse`: within 1e-10 (float64 numpy on both
    sides, the same operations).
  - `chain_poses`, `chain_w2c` and the KITTI file: equal (the same numpy
    operations on the same inputs).
  - `vo_pair_pose`: its hypotheses solve the 8-point system on raw
    normalized coordinates in float32, as the reference does, which is
    ill-conditioned (tests/test_torch_auc.py): the two packages' LAPACK
    solves of one sample can differ enough to pick another winner. Where
    both reach the same consensus set (equal final inlier masks of the
    essential RANSAC), R and t agree within 1e-3 (5.3e-4 measured: the
    float32 refit on ~230 inliers differs in A^T A's summation order)
    and the recoverPose inlier counts are equal; `ok` is equal on every seed. The points are
    the splat sequence's blobs projected into two consecutive frames,
    15% of them outliers. With 0.1 px of noise the sets are equal on at
    least 10 of 12 seeds (12 measured at 256 hypotheses). With 0.5 px,
    residuals of many points lie near the 1 px Sampson threshold and one
    or two of them land on the other side in the other package: the sets
    are equal on at least 5 of 12 seeds at 64 hypotheses (6 measured; 2
    at 256 hypotheses, where the best hypothesis is more often a near
    tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.tasks import trajectory as jt
from keypoint_bench_tpu.tasks import vo as jvo
from keypoint_bench_tpu_torch.datasets.synthetic import (
    SyntheticSplatSequenceDataset, rodrigues)
from keypoint_bench_tpu_torch.geometry import ransac as tr
from keypoint_bench_tpu_torch.tasks import auc as ta
from keypoint_bench_tpu_torch.tasks import trajectory as tt
from keypoint_bench_tpu_torch.tasks import vo as tvo
from keypoint_bench_tpu_torch.tasks.vo_ba import chain_w2c


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _similar(seed):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 2, (30, 3))
    R = rodrigues(rng.normal(0, 0.5, 3))
    est = ((gt - rng.normal(0, 2, 3)) @ R) / rng.uniform(0.5, 2.0)
    return est + rng.normal(0, 0.01, est.shape), gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_umeyama_and_ate_match_jax(seed):
    est, gt = _similar(seed)
    for with_scale in (True, False):
        s, R, t = tt.umeyama_align(est, gt, with_scale)
        sj, Rj, tj = jt.umeyama_align(est, gt, with_scale)
        assert abs(s - sj) <= 1e-10
        np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(t, tj, rtol=0, atol=1e-10)
        for align in (True, False):
            assert abs(tt.ate_rmse(est, gt, align, with_scale)
                       - jt.ate_rmse(est, gt, align, with_scale)) <= 1e-10
    assert tt.ate_rmse(est, gt) < 0.1 < tt.ate_rmse(est, gt, align=False)


def _relative(n, seed):
    rng = np.random.default_rng(seed)
    R = np.stack([rodrigues(rng.normal(0, 0.05, 3)) for _ in range(n)])
    t = rng.normal(0, 1, (n, 3))
    ok = rng.random(n) > 0.2
    scales = rng.uniform(0, 0.5, n)
    scales[[0, n // 2]] = [0.0, 0.0005]          # below the 0.001 cut
    return (R.astype(np.float32), t.astype(np.float32), ok, scales)


def test_chain_poses_and_kitti_file_match_jax(tmp_path):
    R, t, ok, scales = _relative(9, 0)
    got = tvo.chain_poses(R, t, ok, scales)
    want = jvo.chain_poses(R, t, ok, scales)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert got[0].shape == (10, 3, 3) and got[1].shape == (10, 3, 1)
    tvo.write_kitti_trajectory(str(tmp_path / "t.txt"), *got)
    jvo.write_kitti_trajectory(str(tmp_path / "j.txt"), *want)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    Rr, tr_ = tt.read_kitti_trajectory(str(tmp_path / "t.txt"))
    Rj, tj = jt.read_kitti_trajectory(str(tmp_path / "t.txt"))
    assert np.array_equal(Rr, Rj) and np.array_equal(tr_, tj)
    np.testing.assert_allclose(Rr, got[0], rtol=0, atol=1e-15)


def test_chain_w2c_matches_the_jax_runners_loop():
    """The world-to-camera chain of the JAX runner's BA branch
    (runner.py:1062-1075), written out as it is there."""
    R, t, ok, scales = _relative(7, 1)
    scales = scales.tolist()
    R_w2c, t_w2c = [np.eye(3)], [np.zeros(3)]
    for i in range(1, 7):
        s = scales[i] if scales[i] >= 0.001 and ok[i] else 0.0
        R_w2c.append(R[i] @ R_w2c[-1])
        t_w2c.append(R[i] @ t_w2c[-1] + s * t[i])
    got = chain_w2c(R, t, ok, np.asarray(scales))
    assert np.array_equal(got[0], np.stack(R_w2c))
    assert np.array_equal(got[1], np.stack(t_w2c))


_SPLAT = SyntheticSplatSequenceDataset(2, 256, 0, 900)


def _splat_matches(seed, noise, k=300, fy=None):
    """The splat scene's blobs seen from frames 0 and 1, projected with
    (fx, fy) and `noise` px of noise; 10% of the rows masked out, 15%
    moved 10-30 px (outliers). Returns pixel p0, p1 [k, 2], mask [k], (fx, cx,
    cy)."""
    rng = np.random.default_rng(seed)
    Kc = _SPLAT.base.K.astype(np.float64)
    fx, cx, cy = Kc[0, 0], Kc[0, 2], Kc[1, 2]
    fy = fx if fy is None else fy
    T0, T1 = _SPLAT.poses_cam[0], _SPLAT.poses_cam[1]
    X = _SPLAT.X[rng.permutation(len(_SPLAT.X))[:k]]

    def project(T):
        Xc = X @ T[:3, :3].T + T[:3, 3]
        return np.c_[fx * Xc[:, 0] / Xc[:, 2] + cx,
                     fy * Xc[:, 1] / Xc[:, 2] + cy]

    p0 = project(T0) + rng.normal(0, noise, (k, 2))
    p1 = project(T1) + rng.normal(0, noise, (k, 2))
    bad = rng.random(k) < 0.15
    p1[bad] += rng.uniform(10, 30, (int(bad.sum()), 2)) * rng.choice(
        [-1.0, 1.0], (int(bad.sum()), 2))
    mask = rng.random(k) > 0.1
    return (p0.astype(np.float32), p1.astype(np.float32), mask,
            (np.float32(fx), np.float32(cx), np.float32(cy)))


def _jax_pair(p0, p1, mask, f, key, n_hyp):
    """JAX's vo_pair_pose, its consensus set and its minimal samples."""
    fx, cx, cy = (jnp.asarray(v) for v in f)
    R, t, n_in, ok = jvo.vo_pair_pose(jnp.asarray(p0), jnp.asarray(p1),
                                      jnp.asarray(mask), fx, cx, cy, key,
                                      n_hyp=n_hyp)
    pp = jnp.stack([cx, cy])
    _, inl, _ = jr.ransac_essential(
        (jnp.asarray(p0) - pp[None]) / fx, (jnp.asarray(p1) - pp[None]) / fx,
        jnp.asarray(mask), key, n_hyp=n_hyp, thresh=1.0 / fx)
    idx = np.array(jr._sample_minimal(key, jnp.asarray(mask), n_hyp, 8))
    return (np.asarray(R), np.asarray(t), int(n_in), bool(ok),
            np.asarray(inl), idx)


@pytest.mark.parametrize("noise,n_hyp,min_same", [(0.1, 256, 10),
                                                  (0.5, 64, 5)])
def test_vo_pair_pose_batched_matches_jax_per_pair(noise, n_hyp, min_same):
    seeds = range(12)
    data = [_splat_matches(s, noise) for s in seeds]
    refs = [_jax_pair(p0, p1, m, f, jax.random.key(s), n_hyp)
            for s, (p0, p1, m, f) in zip(seeds, data)]
    p0, p1, mask = (torch.from_numpy(np.stack([d[i] for d in data]))
                    for i in range(3))
    fx, cx, cy = data[0][3]
    samples = torch.from_numpy(np.stack([r[5] for r in refs])).long()
    R, t, n_in, ok = tvo.vo_pair_pose(p0, p1, mask, fx, cx, cy, None,
                                      n_hyp, samples=samples)
    assert R.shape == (12, 3, 3) and t.shape == (12, 3)
    assert n_in.shape == ok.shape == (12,)
    # the consensus sets, from the port's RANSAC on the same normalization
    pp = torch.tensor([cx, cy])
    _, inl, _ = tr.ransac_essential_from_samples(
        (p0 - pp) / float(fx), (p1 - pp) / float(fx), mask, samples,
        1.0 / torch.tensor(fx))
    same = 0
    for i, (Rj, tj, nj, okj, inlj, _) in enumerate(refs):
        assert bool(ok[i]) == okj is True, i
        if not np.array_equal(inl[i].numpy(), inlj):
            continue
        same += 1
        np.testing.assert_allclose(R[i].numpy(), Rj, rtol=0, atol=1e-3)
        np.testing.assert_allclose(t[i].numpy(), tj, rtol=0, atol=1e-3)
        assert int(n_in[i]) == nj, i
    assert same >= min_same, same


def test_vo_pair_pose_normalizes_by_fx_alone():
    """With fy != fx the pair solve still divides y by fx (a single-focal
    pinhole, like cv2.findEssentialMat(focal, pp)), as JAX's does; AUC's
    (fx, fy) normalization gives another problem."""
    p0, p1, mask, (fx, cx, cy) = _splat_matches(3, 0.1, fy=160.0)
    key = jax.random.key(3)
    Rj, tj, nj, okj, inlj, idx = _jax_pair(p0, p1, mask, (fx, cx, cy), key,
                                           64)
    args = [torch.from_numpy(a) for a in (p0, p1, mask)]
    samples = torch.from_numpy(idx).long()
    R, t, n_in, ok = tvo.vo_pair_pose(*args, fx, cx, cy, None, 64,
                                      samples=samples)
    assert bool(ok) == okj
    pp = torch.tensor([cx, cy])
    p0n, p1n = (args[0] - pp) / float(fx), (args[1] - pp) / float(fx)
    E, inl, _ = tr.ransac_essential_from_samples(
        p0n, p1n, args[2], samples, 1.0 / torch.tensor(fx))
    Rw, tw, _, nw = tr.recover_pose(E, p0n, p1n, inl)
    assert torch.equal(R, Rw) and torch.equal(t, tw) and int(n_in) == int(nw)
    if np.array_equal(inl.numpy(), inlj):
        np.testing.assert_allclose(R.numpy(), Rj, rtol=0, atol=1e-3)
        np.testing.assert_allclose(t.numpy(), tj, rtol=0, atol=1e-3)
    Kfy = torch.tensor([[fx, 0, cx], [0, 160.0, cy], [0, 0, 1]])
    _, t_fy, _, _, ok_fy = ta.estimate_pose_pair(*args, Kfy, Kfy, None,
                                                 n_hyp=64, samples=samples)
    assert bool(ok_fy) and float((t - t_fy).abs().max()) > 1e-2


def test_vo_pair_pose_draws_from_the_generator():
    p0, p1, mask, (fx, cx, cy) = _splat_matches(0, 0.1)
    args = [torch.from_numpy(np.stack([a, a])) for a in (p0, p1, mask)]
    outs = [tvo.vo_pair_pose(*args, fx, cx, cy,
                             torch.Generator().manual_seed(5), 64)
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    R, t, n_in, ok = outs[0]
    assert bool(ok.all()) and int(n_in.min()) > 100
    # per-pair intrinsics broadcast like scalars
    per = tvo.vo_pair_pose(*args, torch.tensor([fx, fx]),
                           torch.tensor([cx, cx]), torch.tensor([cy, cy]),
                           torch.Generator().manual_seed(5), 64)
    for a, b in zip(per, outs[0]):
        assert torch.equal(a, b)
