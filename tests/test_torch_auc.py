"""The AUC slice in the PyTorch port vs the JAX reference (CPU): essential
RANSAC with recoverPose, pose error and AUC, `pipeline.xfeat_auc_step`,
and the runner's AUC task.

torch's and JAX's random streams differ, so the port is fed the minimal
samples that JAX's `_sample_minimal` draws from the same keys.

Tolerances and what limits them:
  - the essential projection within 1e-5; recoverPose on one E: R within
    1e-5, t within 1e-5 up to sign, counts and masks equal, and the pose
    error of that R within 1e-2 degrees (arccos near 0 magnifies R's
    1e-5); pose_error on equal inputs within 1e-3 degrees; pose_auc
    within 1e-12.
  - essential RANSAC: hypotheses solve the 8-point system on raw
    normalized camera coordinates through the SVD of A^T A in float32, as
    the reference does. That system is ill-conditioned: the two packages'
    LAPACK solves of one 8-point sample give hypotheses up to 0.4 apart,
    so the winning hypothesis can differ. Where both reach the same
    consensus set (equal final inlier masks), E agrees within 1e-3 up to
    sign and the pose error within 0.05 degrees. `ok` is equal on every
    seed, and the masks are equal on at least 9 of 12 seeds (10 measured).
  - the step on the plain path at 128^2: keypoint positions, m0 and the
    match mask equal, keypoint scores within 1e-5 (XFeat's heatmaps'
    tolerance), errors within 1e-3 degrees (LightGlue on the randomized
    weights finds no confident match, so every pair fails at 180).
  - the runner (ALIKE-t, brute force, 3 SE3 pairs at 256^2, the JAX
    runner's draws): the gates of tests/test_auc_e2e.py, and per-pair
    errors within 1 degree of the JAX runner's (0.92 degrees measured);
    SE3 repeatability equal to the JAX runner's within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.datasets.synthetic import \
    SyntheticSE3Dataset as JaxSE3Dataset
from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.models import common as jc
from keypoint_bench_tpu.models.lightglue import \
    lightglue_forward as jax_lightglue_forward
from keypoint_bench_tpu.models.lightglue import \
    sample_descriptors_lg as jax_sample_descriptors_lg
from keypoint_bench_tpu.models.xfeat import xfeat
from keypoint_bench_tpu.ops.detect import DetectParams as JaxDetectParams
from keypoint_bench_tpu.ops.detect import \
    detection_batch as jax_detection_batch
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.tasks import auc as ja
from keypoint_bench_tpu_torch.datasets.synthetic import rodrigues
from keypoint_bench_tpu_torch.geometry import ransac as tr
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.pipeline import xfeat_auc_step
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.tasks import auc as ta
from keypoint_bench_tpu_torch.weights import (lightglue_input_proj_params,
                                              load_golden_params,
                                              stage_golden_weights)
from keypoint_bench_tpu_torch.weights.io import golden_npz


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F_PX, C_PX = 230.4, 128.0       # SyntheticSE3Dataset's intrinsics at 256^2
K = np.array([[F_PX, 0, C_PX], [0, F_PX, C_PX], [0, 0, 1]], np.float32)


def _correspondences(seed, k=300, outliers=0.3, noise=0.1):
    """Ground-truth SE3 correspondences (the dataset's pose draws) with
    pixel noise; an outlier is moved 15 to 40 px across its epipolar line,
    and 10% of the rows are masked out. Returns pixel p0, p1 [k, 2], mask,
    T_0to1 [4, 4]."""
    rng = np.random.default_rng(seed)
    R = rodrigues(rng.normal(0, 0.03, 3))
    t = np.array([rng.uniform(0.3, 0.7), rng.uniform(-0.2, 0.2),
                  rng.uniform(-0.1, 0.1)])
    X = np.c_[rng.uniform(-4, 4, (k, 2)), rng.uniform(4, 20, k)]
    X1 = X @ R.T + t
    p0 = X[:, :2] / X[:, 2:] * F_PX + C_PX
    p1 = X1[:, :2] / X1[:, 2:] * F_PX + C_PX + rng.normal(0, noise, (k, 2))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Ki = np.linalg.inv(K.astype(np.float64))
    lines = np.c_[p0, np.ones(k)] @ (Ki.T @ tx @ R @ Ki).T
    n = lines[:, :2] / np.linalg.norm(lines[:, :2], axis=1, keepdims=True)
    bad = rng.random(k) < outliers
    p1[bad] += (rng.uniform(15, 40, bad.sum())
                * rng.choice([-1.0, 1.0], bad.sum()))[:, None] * n[bad]
    mask = rng.random(k) > 0.1
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return (p0.astype(np.float32), p1.astype(np.float32), mask,
            T.astype(np.float32))


def _normalized(p0, p1):
    """The JAX estimate_pose_pair's normalization and threshold."""
    Kj = jnp.asarray(K)
    c, f = Kj[:2, 2], jnp.stack([Kj[0, 0], Kj[1, 1]])
    th = 1.0 / ((Kj[0, 0] + Kj[1, 1] + Kj[0, 0] + Kj[1, 1]) / 4.0)
    return (np.asarray((jnp.asarray(p0) - c) / f),
            np.asarray((jnp.asarray(p1) - c) / f), float(th))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_essential_project_matches_jax():
    E = np.random.default_rng(0).normal(size=(16, 3, 3)).astype(np.float32)
    got = tr._essential_project(torch.from_numpy(E)).numpy()
    want = np.stack([np.asarray(jr._essential_project(jnp.asarray(e)))
                     for e in E])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    s = np.linalg.svd(got.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s[:, 0], s[:, 1], rtol=1e-5)
    assert np.abs(s[:, 2]).max() < 1e-5


def _minimal_designs(seed=0):
    """[3, 50] float64 8 x 9 designs of near-identity minimal samples in
    normalized coordinates, and their null vectors by float64 SVD."""
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(-0.5, 0.5, (3, 50, 8, 2))
    q1 = q0 + rng.uniform(0, 0.05, q0.shape)
    a = tr._eightpoint_design(torch.from_numpy(q0), torch.from_numpy(q1))
    ref = torch.linalg.svd(a.transpose(-1, -2) @ a)[2][..., -1, :]
    return a, ref


def test_nullvec_minors_is_the_design_null_vector():
    """The CUDA hypothesis solve's algorithm (the signed 8 x 8 minors in
    float64), run on the CPU: the float64 SVD's null vector up to sign
    within 1e-12; a sample with two equal correspondences (rank 7) is
    invalid and counts no inliers."""
    a, ref = _minimal_designs()
    v, valid = tr._nullvec_minors(a)
    assert bool(valid.all())
    assert float((1 - (v * ref).sum(-1).abs()).abs().max()) < 1e-12
    assert float((a @ v[..., None]).abs().max()) < 1e-12
    a[0, 0, 7] = a[0, 0, 6]
    v, valid = tr._nullvec_minors(a)
    assert not bool(valid[0, 0]) and int(valid.sum()) == 149
    assert float(v[0, 0].abs().max()) == 0.0


def test_solve_minimal_e_on_the_cpu_is_the_float32_svd():
    """On the CPU the hypotheses stay the JAX package's float32 SVD of
    A^T A, every sample valid."""
    rng = np.random.default_rng(1)
    q0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 16, 8, 2))
                          .astype(np.float32))
    q1 = q0 + 0.05
    e, valid = tr._solve_minimal_e(q0, q1)
    assert e.dtype == torch.float32 and bool(valid.all())
    assert torch.equal(e, tr._solve_eightpoint(q0, q1,
                                               torch.ones_like(q0[..., 0])))


@pytest.mark.cuda
def test_solve_minimal_e_on_cuda_is_the_float64_null_vector():
    """On CUDA the hypotheses are the float64 null vectors of the designs
    (float32 E within 1e-6 of the float64 SVD's, up to sign)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(2)
    q0 = rng.uniform(-0.5, 0.5, (3, 50, 8, 2)).astype(np.float32)
    q1 = (q0 + rng.uniform(0, 0.05, q0.shape)).astype(np.float32)
    e, valid = tr._solve_minimal_e(torch.from_numpy(q0).cuda(),
                                   torch.from_numpy(q1).cuda())
    a = tr._eightpoint_design(torch.from_numpy(q0).double(),
                              torch.from_numpy(q1).double())
    ref = torch.linalg.svd(a.transpose(-1, -2) @ a)[2][..., -1, :]
    v = e.cpu().double().flatten(-2)
    assert bool(valid.all())
    assert float((1 - (v * ref).sum(-1).abs()).abs().max()) < 1e-6


def test_ransac_essential_from_jax_samples():
    equal_masks = 0
    for seed in range(12):
        p0, p1, mask, T = _correspondences(seed)
        p0n, p1n, th = _normalized(p0, p1)
        key = jax.random.key(seed)
        E_ref, inl_ref, ok_ref = jr.ransac_essential(
            jnp.asarray(p0n), jnp.asarray(p1n), jnp.asarray(mask), key,
            n_hyp=64, thresh=th)
        idx = np.array(jr._sample_minimal(key, jnp.asarray(mask), 64, 8))
        E, inl, ok = tr.ransac_essential_from_samples(
            *_t(p0n, p1n, mask, idx), th)
        assert bool(ok) == bool(ok_ref) is True, seed
        if not np.array_equal(inl.numpy(), np.asarray(inl_ref)):
            continue
        equal_masks += 1
        E_ref = np.asarray(E_ref)
        sign = np.sign((E.numpy() * E_ref).sum())
        np.testing.assert_allclose(sign * E.numpy(), E_ref, rtol=0,
                                   atol=1e-3, err_msg=str(seed))
        err = ta.pose_error(*tr.recover_pose(E, *_t(p0n, p1n, inl))[:2],
                            torch.from_numpy(T))
        err_ref = ja.pose_error(*jr.recover_pose(
            jnp.asarray(E_ref), jnp.asarray(p0n), jnp.asarray(p1n),
            inl_ref)[:2], jnp.asarray(T))
        assert abs(float(err) - float(err_ref)) < 0.05, seed
    assert equal_masks >= 9


def test_ransac_essential_and_estimate_draw_from_the_generator():
    """Without `samples`, the minimal samples come from the generator: the
    same as passing the samples it draws."""
    p0, p1, mask, _ = _correspondences(0)
    p0n, p1n, th = _normalized(p0, p1)
    args = _t(p0n, p1n, mask)
    idx = tr._sample_minimal(args[2], 64, 8, torch.Generator().manual_seed(3))
    got = tr.ransac_essential(*args, torch.Generator().manual_seed(3), 64, th)
    want = tr.ransac_essential_from_samples(*args, idx, th)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pix = _t(p0, p1, mask, K, K)
    got = ta.estimate_pose_pair(*pix, torch.Generator().manual_seed(3),
                                n_hyp=64)
    want = ta.estimate_pose_pair(*pix, None, samples=idx)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_recover_pose_and_decompose_match_jax(seed):
    p0, p1, mask, T = _correspondences(seed)
    p0n, p1n, th = _normalized(p0, p1)
    E, inl, _ = jr.ransac_essential(jnp.asarray(p0n), jnp.asarray(p1n),
                                    jnp.asarray(mask), jax.random.key(seed),
                                    n_hyp=64, thresh=th)
    R1, R2, t = tr.decompose_essential(*_t(E))
    R1r, R2r, tr_ = map(np.asarray, jr.decompose_essential(E))
    # LAPACK and cuSOLVER may swap R1 and R2 and flip t
    pairs = ((R1, R1r), (R2, R2r)) if np.abs(R1.numpy() - R1r).max() < 1e-3 \
        else ((R1, R2r), (R2, R1r))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.abs(t.numpy()), np.abs(tr_), rtol=0,
                               atol=1e-5)
    R, t, pose_mask, count = tr.recover_pose(*_t(E, p0n, p1n, inl))
    Rr, t_r, pm_r, c_r = jr.recover_pose(E, jnp.asarray(p0n),
                                         jnp.asarray(p1n), inl)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.abs(t.numpy()), np.abs(np.asarray(t_r)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pose_mask.numpy(), np.asarray(pm_r))
    assert int(count) == int(c_r) > 100
    err = float(ta.pose_error(R, t, torch.from_numpy(T)))
    # R within 1e-5 moves an angle near 0 by up to 0.01 degrees through
    # arccos: pose_error itself is held within 1e-3 on equal inputs below
    assert abs(err - float(ja.pose_error(Rr, t_r, jnp.asarray(T)))) < 1e-2
    assert err < 5.0


def test_recover_pose_takes_batch_dims():
    items = [_correspondences(s) for s in (0, 2)]
    norm = [_normalized(p0, p1) for p0, p1, _, _ in items]
    Es = [np.asarray(jr.ransac_essential(
        jnp.asarray(n[0]), jnp.asarray(n[1]), jnp.asarray(it[2]),
        jax.random.key(s), n_hyp=64, thresh=n[2])[0])
        for s, it, n in zip((0, 2), items, norm)]
    stacked = tr.recover_pose(*_t(np.stack(Es),
                                  np.stack([n[0] for n in norm]),
                                  np.stack([n[1] for n in norm]),
                                  np.stack([it[2] for it in items])))
    for i in range(2):
        one = tr.recover_pose(*_t(Es[i], norm[i][0], norm[i][1],
                                  items[i][2]))
        R, t, pose_mask, count = one
        assert torch.equal(pose_mask, stacked[2][i])
        assert torch.equal(count, stacked[3][i])
        assert torch.allclose(R, stacked[0][i], rtol=0, atol=1e-6)
        assert torch.allclose(t, stacked[1][i], rtol=0, atol=1e-6)


def test_pose_error_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        R = rodrigues(rng.normal(0, 0.5, 3)).astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = rodrigues(rng.normal(0, 0.5, 3))
        T[:3, 3] = rng.normal(size=3)
        got = float(ta.pose_error(*_t(R, t, T)))
        want = float(ja.pose_error(*map(jnp.asarray, (R, t, T))))
        assert abs(got - want) < 1e-3
    batch = ta.pose_error(*_t(np.stack([R, R]), np.stack([t, -t]),
                              np.stack([T, T])))
    assert torch.allclose(batch, torch.full((2,), got), atol=1e-4)


@pytest.mark.parametrize("errors", [
    [0.5, 3.0, 7.5, 12.0, 25.0, 180.0],
    [180.0, 180.0],
    [0.0, 1e-3, 4.99, 5.0, 9.99, 10.0, 19.99, 20.0],
    list(np.random.default_rng(0).random(40) * 30)])
def test_pose_auc_matches_jax(errors):
    np.testing.assert_allclose(ta.pose_auc(errors), ja.pose_auc(errors),
                               rtol=0, atol=1e-12)


def test_five_point_solver_estimates_the_pose():
    """solver 5pt (tests/test_torch_fivepoint.py holds it against JAX) on
    these correspondences: the pose within 1 degree, most inliers kept."""
    p0, p1, mask, T = _correspondences(0)
    R, t, _, n_in, ok = ta.estimate_pose_pair(
        *_t(p0, p1, mask, K, K), torch.Generator().manual_seed(0),
        n_hyp=512, solver="5pt")
    assert bool(ok) and int(n_in) > 0.5 * mask.sum()
    assert float(ta.pose_error(R, t, torch.from_numpy(T))) < 1.0


@pytest.fixture
def highest():
    jc.set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    jc.set_conv_precision(None)


def _jax_auc_chain(items, n_hyp, dp):
    """bench.py:275-293's step on the JAX package, pair by pair, with the
    minimal samples it draws."""
    params = {k: jnp.asarray(v) for k, v in golden_npz("XFeat").items()}
    lg = {k: jnp.asarray(v) for k, v in golden_npz("lightglue").items()}
    dim = int(lg["transformers.0.self_attn.Wqkv.weight"].shape[0])
    lg["input_proj.weight"] = jnp.asarray(
        np.random.default_rng(7).normal(0, 0.1, (64, dim)), jnp.float32)
    lg["input_proj.bias"] = jnp.zeros((dim,), jnp.float32)
    imgs = [jnp.asarray(np.stack([it[k] for it in items]))
            for k in ("image0", "image1")]
    size = imgs[0].shape[1]
    scale = jnp.asarray([size - 1.0, size - 1.0])
    s0, d0 = xfeat(params, imgs[0])
    s1, d1 = xfeat(params, imgs[1])
    k0b, v0b = jax_detection_batch(s0, dp)
    k1b, v1b = jax_detection_batch(s1, dp)
    keys = jax.random.split(jax.random.key(0), len(items))
    out = {k: [] for k in ("err", "m0", "mask", "idx")}
    for i, it in enumerate(items):
        Kp = jnp.asarray(it["warp01_params"]["intrinsics0"])
        p0, p1 = k0b[i, :, :2] * scale, k1b[i, :, :2] * scale
        f0 = jax_sample_descriptors_lg(p0, d0[i], 8)
        f1 = jax_sample_descriptors_lg(p1, d1[i], 8)
        m0, _, ok = jax_lightglue_forward(lg, p0, v0b[i], f0, p1, v1b[i],
                                          f1)
        mask = ok & v0b[i]
        R, t, _, _, okp = ja.estimate_pose_pair(
            p0, p1[jnp.maximum(m0, 0)], mask, Kp, Kp, keys[i], n_hyp=n_hyp)
        pose = jnp.asarray(it["warp01_params"]["pose01"])
        out["err"].append(float(jnp.where(okp, ja.pose_error(R, t, pose),
                                          180.0)))
        out["m0"].append(np.asarray(m0))
        out["mask"].append(np.asarray(mask))
        out["idx"].append(np.asarray(jr._sample_minimal(keys[i], mask,
                                                        n_hyp, 8)))
    return np.asarray(k0b), np.asarray(k1b), out


def test_xfeat_auc_step_matches_jax_chain(highest):
    items = [JaxSE3Dataset(2, 128, 0, 200)[i] for i in range(2)]
    dpj = JaxDetectParams(nms_dist=6, border_dist=8, top_k=1000)
    k0r, k1r, ref = _jax_auc_chain(items, 64, dpj)
    model = get_model("XFeat")(load_golden_params("XFeat")).eval()
    imgs0, imgs1 = (np.stack([it[k] for it in items])
                    for k in ("image0", "image1"))
    Ks = np.stack([it["warp01_params"]["intrinsics0"] for it in items])
    poses = np.stack([it["warp01_params"]["pose01"] for it in items])
    err, n_in, k0, k1, m0, mask = xfeat_auc_step(
        model, lightglue_input_proj_params(), imgs0, imgs1, Ks, poses,
        DetectParams(nms_dist=6, border_dist=8, top_k=1000), None, n_hyp=64,
        samples=torch.from_numpy(np.stack(ref["idx"])), device="cpu")
    for got, want in ((k0, k0r), (k1, k1r)):
        # positions equal; the score column within the heatmaps' 1e-5
        np.testing.assert_array_equal(got[..., :2].numpy(), want[..., :2])
        np.testing.assert_allclose(got[..., 2].numpy(), want[..., 2],
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(m0.numpy(), np.stack(ref["m0"]))
    np.testing.assert_array_equal(mask.numpy(), np.stack(ref["mask"]))
    np.testing.assert_allclose(err.numpy(), ref["err"], rtol=0, atol=1e-3)
    assert err.shape == n_in.shape == (2,) and k0.shape == (2, 1000, 3)
    assert int(k0[..., 2].gt(0).sum()) > 100


def _auc_cfg(out, model="Alike", matcher="brute_force", size=256, pairs=3,
             **kw):
    mp = {"type": matcher, "brute_force_params": {"max_distance": 5.0}}
    return dict(model_type=model, task_type="AUC",
                data_params={"type": "synthetic_se3", "num_pairs": pairs,
                             "image_size": size},
                extractor_params={"nms_dist": 4, "threshold": 0,
                                  "border_dist": 8, "top_k": 500,
                                  "min_score": 0.0},
                matcher_params=mp, task_params={"th": [5, 10, 20]},
                output_dir=str(out), **kw)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's runner draws its minimal samples as the JAX runner does:
    one split of the seed-0 key per pair."""
    state = {"key": jax.random.key(0)}

    def draws(mask, n_hyp, size, generator):
        state["key"], k = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jr._sample_minimal(
            k, jnp.asarray(mask.numpy()), n_hyp, size))).long()

    monkeypatch.setattr(ta, "_sample_minimal", draws)


def test_auc_runner_matches_jax_runner(tmp_path, jax_draws):
    res = Evaluator(EvalConfig(**_auc_cfg(tmp_path / "t")), "cpu").run()
    ref = JaxEvaluator(JaxEvalConfig(**_auc_cfg(tmp_path / "j"))).run()
    errs = np.asarray(res["per_pair_error"])
    assert len(errs) == 3
    assert np.median(errs) < 10.0, errs
    assert res["AUC@20"] > 0.3, res
    np.testing.assert_allclose(errs, ref["per_pair_error"], rtol=0, atol=1.0)
    assert sorted(res) == sorted(ref)


def test_se3_repeatability_runner_matches_jax_runner(tmp_path):
    cfg = _auc_cfg(tmp_path, pairs=2)
    cfg.update(task_type="repeatability", task_params={"th": 3},
               matcher_params={})
    res = Evaluator(EvalConfig(**cfg), "cpu").run()
    ref = JaxEvaluator(JaxEvalConfig(**cfg)).run()
    assert res["repeatability"] > 0.1, res
    np.testing.assert_allclose(res["per_pair_repeatability"],
                               ref["per_pair_repeatability"], rtol=0,
                               atol=1e-6)


def test_se3_repeatability_batch_size_runs_per_pair_loop(tmp_path):
    """The JAX runner's sharded repeatability path stacks homography warps
    only: SE3 pairs run the per-pair loop at any batch size."""
    runs = []
    for bs in (1, 2):
        cfg = _auc_cfg(tmp_path / f"bs{bs}", size=64, pairs=2)
        cfg.update(task_type="repeatability", task_params={"th": 3},
                   matcher_params={})
        cfg["data_params"]["batch_size"] = bs
        runs.append(Evaluator(EvalConfig(**cfg), "cpu").run())
    assert runs[1] == runs[0] and len(runs[0]["per_pair_repeatability"]) == 2


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return stage_golden_weights(str(tmp_path_factory.mktemp("weights")))


def test_auc_runner_light_glue_matches_jax_runner(tmp_path, weights,
                                                  jax_draws):
    cfg = _auc_cfg(tmp_path, "SuperPoint", "light_glue", size=128,
                   pairs=2, weights_dir=weights)
    res = Evaluator(EvalConfig(**cfg), "cpu").run()
    ref = JaxEvaluator(JaxEvalConfig(**cfg)).run()
    np.testing.assert_allclose(res["per_pair_error"], ref["per_pair_error"],
                               rtol=0, atol=1e-3)
    assert res["AUC@20"] == pytest.approx(ref["AUC@20"], abs=1e-6)


def test_xfeat_light_glue_falls_back_only_when_asked(tmp_path, weights):
    cfg = _auc_cfg(tmp_path, "XFeat", "light_glue", size=128, pairs=1,
                   weights_dir=weights)
    with pytest.raises(RuntimeError, match="no LightGlue adapter"):
        Evaluator(EvalConfig(**cfg), "cpu")
    cfg["matcher_params"]["light_glue_params"] = {"allow_fallback": True}
    with pytest.warns(UserWarning, match="falling back"):
        ev = Evaluator(EvalConfig(**cfg), "cpu")
    res = ev.run()
    assert res["matcher_fallback"] == "brute_force"
    assert len(res["per_pair_error"]) == 1


def test_auc_runner_raises_on_an_unknown_solver(tmp_path):
    cfg = {**_auc_cfg(tmp_path, size=64, pairs=1),
           "task_params": {"solver": "7pt"}}
    with pytest.raises(ValueError, match="unknown solver"):
        Evaluator(EvalConfig(**cfg), "cpu").run()


def test_auc_batch_size_runs_the_batch_path(tmp_path):
    """Brute force at batch_size 2 runs the data-parallel batch path
    (tests/test_torch_parallel_runner.py holds it against the JAX
    runner)."""
    cfg = {**_auc_cfg(tmp_path, size=64, pairs=1),
           "data_params": {"type": "synthetic_se3", "num_pairs": 2,
                           "image_size": 64, "batch_size": 2}}
    res = Evaluator(EvalConfig(**cfg), "cpu").run()
    assert len(res["per_pair_error"]) == 2


def test_save_images_writes_the_auc_match_overlay(tmp_path):
    """The run writes the JAX runner's match overlay of its pair (its
    pixels against the JAX runner's: tests/test_torch_visualization.py)."""
    cfg = {**_auc_cfg(tmp_path, size=64, pairs=1),
           "task_params": {"save_images": True}}
    Evaluator(EvalConfig(**cfg), "cpu").run()
    assert [p.name for p in tmp_path.glob("*.png")] == ["auc_matches_0.png"]
