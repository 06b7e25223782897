"""The five-point essential solver and its RANSAC in the PyTorch port vs
the JAX reference (CPU, float32).

The two packages' `eigh` return different bases of the 4-dim E-nullspace
(the 4 smallest eigenvalues are zero up to rounding), so the solver's
stages are compared on shared inputs: the template on JAX's basis (equal
within 1e-6 of its largest coefficient), the action matrix on JAX's
template (within 1e-3 of its largest entry; 5.2e-5 measured, the two
LAPACK solves), and the roots on JAX's action matrix. A root is found
where the sign of det(T - z I) changes, and near a root that sign is
rounding, so the two bisections end apart by up to 4.2e-3 relative on
these problems (94% within 1e-4; measured): the sets of valid roots must
be equal on 28 of 30 problems (29 measured), every root within 1e-2
relative and 90% of them within 1e-4. End to end on each package's own
basis, the true E must be among the valid candidates on 75% of the
problems (tests/test_fivepoint.py's bound; 30 of 30 measured), and each
of JAX's valid candidates within 0.05 of one of the port's, up to sign
(0.034 measured).

RANSAC is fed the minimal samples JAX's `_sample_minimal` draws from the
same keys: ok and the inlier masks equal, E within 1e-3 up to sign (the
8-point path's bound in tests/test_torch_auc.py; 1.4e-4 measured, the
float32 refit on ~230 inliers) and the pose error within 0.05 degrees.
The AUC runner with solver 5pt against the JAX runner on 2 SE3 pairs at
256^2 with the JAX runner's draws: the per-pair errors within 1 degree,
as the 8-point runner test holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.geometry import fivepoint as jf
from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.tasks import auc as ja
from keypoint_bench_tpu_torch.datasets.synthetic import rodrigues
from keypoint_bench_tpu_torch.geometry import fivepoint as tf
from keypoint_bench_tpu_torch.geometry import ransac as tr
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.tasks import auc as ta

N_MINIMAL = 30


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small batched solves and convs a call, which torch's intra-op
    threads slow down where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _minimal_problems():
    """tests/test_fivepoint.py's exact problems: 5 correspondences in
    normalized camera coordinates, 5 held-out ones, the true E."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(N_MINIMAL):
        R = rodrigues(rng.normal(0, 0.3, 3))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = rng.uniform([-1, -1, 3], [1, 1, 8], (10, 3))
        x0 = X[:, :2] / X[:, 2:3]
        X1 = X @ R.T + t
        x1 = X1[:, :2] / X1[:, 2:3]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]])
        out.append((x0.astype(np.float32), x1.astype(np.float32), tx @ R))
    return out


@pytest.fixture(scope="module")
def minimal():
    return _minimal_problems()


@pytest.fixture(scope="module")
def jax_stages(minimal):
    """JAX's basis, template, action matrix, roots and candidates of every
    problem."""
    @jax.jit
    def stages(p0, p1):
        eb = jf._null4(p0, p1)
        m = jf._template(eb)
        t = jf._action_matrix(m)
        return (eb, m, t, *jf._real_eigs_by_bisection(t),
                *jf.five_point_candidates(p0, p1))

    return [[np.array(x) for x in stages(x0[:5], x1[:5])]
            for x0, x1, _ in minimal]


def test_template_and_action_matrix_match_jax(jax_stages):
    for eb, m, t, *_ in jax_stages:
        got = tf._template(torch.from_numpy(eb)).numpy()
        np.testing.assert_allclose(got, m, rtol=0,
                                   atol=1e-6 * np.abs(m).max())
        got = tf._action_matrix(torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, t, rtol=0,
                                   atol=1e-3 * np.abs(t).max())
    # the batched call equals the calls one at a time
    ebs = torch.from_numpy(np.stack([s[0] for s in jax_stages]))
    np.testing.assert_array_equal(
        tf._template(ebs).numpy(),
        np.stack([tf._template(e).numpy() for e in ebs]))


def test_roots_match_jax_on_a_shared_action_matrix(jax_stages):
    t = torch.from_numpy(np.stack([s[2] for s in jax_stages]))
    roots, valid = (x.numpy() for x in tf._real_eigs_by_bisection(t))
    rel, equal = [], 0
    for (_, _, _, jroots, jvalid, *_), z, v in zip(jax_stages, roots, valid):
        if not np.array_equal(v, jvalid):
            continue
        equal += 1
        rel += list(np.abs(z - jroots)[v] / np.abs(jroots[v]))
    rel = np.asarray(rel)
    assert equal >= N_MINIMAL - 2, equal
    assert len(rel) > 100 and rel.max() < 1e-2, rel.max()
    assert (rel < 1e-4).mean() >= 0.9, (rel < 1e-4).mean()


def test_candidates_hold_the_true_essential_matrix(minimal, jax_stages):
    x0s = torch.from_numpy(np.stack([p[0][:5] for p in minimal]))
    x1s = torch.from_numpy(np.stack([p[1][:5] for p in minimal]))
    es, valid = (x.numpy() for x in tf.five_point_candidates(x0s, x1s))
    assert es.shape == (N_MINIMAL, 10, 3, 3) and valid.shape == (N_MINIMAL,
                                                                  10)
    hits, jax_hits, gaps = 0, 0, []
    for (x0, x1, _), e, v, st in zip(minimal, es, valid, jax_stages):
        ph0 = np.c_[x0[5:], np.ones(5)]
        ph1 = np.c_[x1[5:], np.ones(5)]

        def held_out(cands, ok):
            res = [np.abs(np.sum(ph1 * (ph0 @ c.T), 1)).max()
                   for c, o in zip(cands, ok) if o]
            return min(res, default=np.inf) < 2e-3

        hits += held_out(e, v)
        jax_hits += held_out(st[5], st[6])
        np.testing.assert_allclose(np.linalg.norm(e[v], axis=(1, 2)), 1.0,
                                   atol=1e-5)
        for c in st[5][st[6]]:
            gaps.append(min((np.abs(c - s * o).max() for o in e[v]
                             for s in (1, -1)), default=np.inf))
    assert hits >= 0.75 * N_MINIMAL and jax_hits >= 0.75 * N_MINIMAL
    assert max(gaps) < 0.05, max(gaps)


def _pose_problem(seed, n=300, n_out=60, noise=0.3):
    """tests/test_fivepoint.py's pose problem (K = 500 px, 300 points, 60
    outliers, 0.3 px noise) with 10 rows masked out: normalized p0n, p1n,
    mask and the true T_0to1."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    R = rodrigues(rng.normal(0, 0.1, 3))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 10, n)]
    x0 = X @ K.T
    x1 = (X @ R.T + t) @ K.T
    p0 = x0[:, :2] / x0[:, 2:] + rng.normal(0, noise, (n, 2))
    p1 = x1[:, :2] / x1[:, 2:] + rng.normal(0, noise, (n, 2))
    p1[:n_out] = rng.uniform(0, 640, (n_out, 2))
    mask = np.ones(n, bool)
    mask[rng.choice(n, 10, replace=False)] = False
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    f32 = [((p - K[:2, 2]) / K[[0, 1], [0, 1]]).astype(np.float32)
           for p in (p0, p1)]
    return f32[0], f32[1], mask, T.astype(np.float32)


def test_ransac_5pt_from_jax_samples():
    for seed in range(6):
        p0n, p1n, mask, T = _pose_problem(seed)
        key = jax.random.key(seed)
        args = [jnp.asarray(x) for x in (p0n, p1n, mask)]
        E_ref, inl_ref, ok_ref = jf.ransac_essential_5pt(
            *args, key, n_hyp=64, thresh=1 / 500)
        idx = np.array(jr._sample_minimal(key, args[2], 64, 5))
        t_args = [torch.from_numpy(x) for x in (p0n, p1n, mask)]
        E, inl, ok = tf.ransac_essential_5pt_from_samples(
            *t_args, torch.from_numpy(idx), 1 / 500)
        assert bool(ok) == bool(ok_ref) is True, seed
        np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_ref))
        E_ref = np.asarray(E_ref)
        sign = np.sign((E.numpy() * E_ref).sum())
        np.testing.assert_allclose(sign * E.numpy(), E_ref, rtol=0,
                                   atol=1e-3, err_msg=str(seed))
        err = ta.pose_error(*tr.recover_pose(E, t_args[0], t_args[1],
                                             inl)[:2], torch.from_numpy(T))
        err_ref = ja.pose_error(*jr.recover_pose(
            jnp.asarray(E_ref), args[0], args[1], inl_ref)[:2],
            jnp.asarray(T))
        assert abs(float(err) - float(err_ref)) < 0.05, seed
        assert float(err) < 2.0, (seed, float(err))


def test_ransac_5pt_batches_and_draws_from_the_generator():
    """Leading batch dimensions give the per-pair results; without samples
    the generator's draws are used, at max(n_hyp // 8, 64) samples in the
    AUC entry point."""
    probs = [_pose_problem(s) for s in (0, 1)]
    p0n, p1n, mask = (torch.from_numpy(np.stack([p[i] for p in probs]))
                      for i in range(3))
    idx = tr._sample_minimal(mask, 64, 5, torch.Generator().manual_seed(1))
    batched = tf.ransac_essential_5pt_from_samples(p0n, p1n, mask, idx,
                                                   1 / 500)
    for i in range(2):
        one = tf.ransac_essential_5pt_from_samples(p0n[i], p1n[i], mask[i],
                                                   idx[i], 1 / 500)
        assert torch.equal(one[1], batched[1][i])
        assert torch.equal(one[2], batched[2][i])
        torch.testing.assert_close(one[0], batched[0][i], atol=1e-5,
                                   rtol=0)
    drawn = tf.ransac_essential_5pt(p0n, p1n, mask,
                                    torch.Generator().manual_seed(1), 64,
                                    1 / 500)
    assert all(torch.equal(a, b) for a, b in zip(drawn, batched))

    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    p0, p1 = (p * 500.0 + torch.tensor([320.0, 240.0]) for p in (p0n, p1n))
    got = ta.estimate_pose_pair(p0, p1, mask, K, K,
                                torch.Generator().manual_seed(2),
                                n_hyp=1024, solver="5pt")
    samples = tr._sample_minimal(mask, 128, 5,
                                 torch.Generator().manual_seed(2))
    want = ta.estimate_pose_pair(p0, p1, mask, K, K, None, solver="5pt",
                                 samples=samples)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(got[4].all()) and (got[3] > 150).all()
    with pytest.raises(ValueError, match="unknown solver"):
        ta.estimate_pose_pair(p0, p1, mask, K, K, None, solver="7pt")


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


def test_auc_runner_5pt_matches_jax_runner(tmp_path, jax_draws):
    cfg = dict(model_type="Alike", task_type="AUC",
               data_params={"type": "synthetic_se3", "num_pairs": 2,
                            "image_size": 256},
               extractor_params={"nms_dist": 4, "threshold": 0,
                                 "border_dist": 8, "top_k": 500,
                                 "min_score": 0.0},
               matcher_params={"type": "brute_force",
                               "brute_force_params": {"max_distance": 5.0}},
               task_params={"th": [5, 10, 20], "solver": "5pt"})
    res = Evaluator(EvalConfig(**cfg, output_dir=str(tmp_path / "t")),
                    "cpu").run()
    ref = JaxEvaluator(JaxEvalConfig(**cfg,
                                     output_dir=str(tmp_path / "j"))).run()
    errs = np.asarray(res["per_pair_error"])
    assert len(errs) == 2 and (errs < 10.0).all(), errs
    np.testing.assert_allclose(errs, ref["per_pair_error"], rtol=0, atol=1.0)
    assert sorted(res) == sorted(ref)
    assert abs(res["AUC_inliers"] - ref["AUC_inliers"]) <= \
        0.05 * ref["AUC_inliers"]
