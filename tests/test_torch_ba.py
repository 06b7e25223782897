"""Bundle adjustment and windowed VO-BA in the PyTorch port vs the JAX
reference (CPU): the LM / Schur solver, reprojection errors, track
chaining, problem building and `refine_window`.

The problems are tests/test_ba.py's kinds (perfect, noisy start, pixel
noise) plus a Huber case with outlier observations, built with the
port's numpy `rodrigues`; the windows are the splat sequence's blobs
projected into 5 frames.

Tolerances and what limits them: both solvers run the same float32
algebra in another summation order (index_add_ against segment_sum,
torch's and XLA's matmuls, LAPACK's dense solve through two bindings).
  - `reprojection_errors` within 1e-4 px: XLA's CPU dot fuses R X into
    one FMA chain and torch does not, so camera points differ by an ulp,
    and a pixel coordinate of 320-640 px resolves only 3.1e-5-6.1e-5 in
    float32 (4.3e-5 measured); 1e-5 is below that resolution.
  - `ba_solve`: with camera 0 fixed, a monocular window still has a free
    scale about camera 0's centre, held only by the damping, and the two
    solvers drift along it differently (t differs by up to 0.037 on the
    noisy start, a scale of 1.023). So the solutions are compared after
    that one scale (`chip_smoke.gauge_gap`): rotations within 1e-4,
    camera centres within 1e-4 and points within 1e-4 of max(1, |X|)
    (1.4e-7, 1.3e-6 and 1.7e-5 measured), the scale within 5% of 1, and
    the mean error within 1e-3 px. The LM accept pattern is equal, or
    both solvers accept the first 3 iterations or more and part at the
    first that one of them rejects; there `c_new < c_old` compares costs that differ at float32's
    resolution (56.12322 against 56.12321 on the pixel-noise problem;
    3.4e-8 against 4.1e-8 from 27496 on the noisy start) and flips.
  - `refine_window`: the same gates on its window (damping 1e-2 holds the
    scale closer), and both mean errors within 1e-3 px.
`chain_tracks` is list-equal; `build_ba_problem` equal (float32 copies of
the same float64 numpy triangulation) on the JAX problem's unpadded part.
"""
import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ba import gauss_newton as jgn
from keypoint_bench_tpu.tasks import vo_ba as jvb
from keypoint_bench_tpu_torch.ba import (BAProblem, ba_solve, lm_iterations,
                                         reprojection_errors)
from keypoint_bench_tpu_torch.ba import gauss_newton as tgn
from keypoint_bench_tpu_torch.datasets.synthetic import (
    SyntheticSplatSequenceDataset, rodrigues)
from keypoint_bench_tpu_torch.tasks import vo_ba as tvb


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
gauge_gap = runpy.run_path(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "chip_smoke.py"), run_name="not_main")["gauge_gap"]


def _assert_same_solution(got, want):
    """Equal up to the free scale about camera 0 (module docstring)."""
    s, gap_r, gap_c, gap_p = gauge_gap(got, want)
    assert abs(s - 1.0) <= 0.05, s
    assert gap_r <= 1e-4 and gap_c <= 1e-4 and gap_p <= 1e-4, (
        gap_r, gap_c, gap_p)


def make_problem(C=6, P=60, noise_px=0.0, pose_noise=0.0, pt_noise=0.0,
                 outliers=0.0, seed=0):
    """tests/test_ba.py's problem as numpy arrays (R, t, points, cam_idx,
    pt_idx, uv, mask), the first camera at the truth; `outliers` of the
    observations moved 20-60 px."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (P, 2)),
                          rng.uniform(6, 12, (P, 1))], axis=1)
    Rs = np.stack([rodrigues(rng.normal(0, 0.05, 3)) for _ in range(C)])
    ts = np.stack([np.array([0.3 * c, 0.05 * c, 0.0])
                   + rng.normal(0, 0.05, 3) for c in range(C)])
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(C):
        for p in range(P):
            Xc = Rs[c] @ pts[p] + ts[c]
            if Xc[2] < 1:
                continue
            cam_idx.append(c)
            pt_idx.append(p)
            uvs.append((K @ (Xc / Xc[2]))[:2] + rng.normal(0, noise_px, 2))
    uv = np.stack(uvs)
    bad = rng.random(len(uv)) < outliers
    uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    if pose_noise > 0:
        Rs = np.stack([Rs[0]] + [rodrigues(rng.normal(0, pose_noise, 3))
                                 @ R for R in Rs[1:]])
        ts = np.concatenate([ts[:1], ts[1:] + rng.normal(
            0, pose_noise * 5, ts[1:].shape)])
    if pt_noise > 0:
        pts = pts + rng.normal(0, pt_noise, pts.shape)
    mask = rng.random(len(uv)) > 0.05
    return (Rs.astype(np.float32), ts.astype(np.float32),
            pts.astype(np.float32), np.asarray(cam_idx), np.asarray(pt_idx),
            uv.astype(np.float32), mask)


def _both(arrays, dtype=torch.float32):
    R, t, pts, ci, pi, uv, mask = arrays
    jp = jgn.BAProblem(jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts),
                       jnp.asarray(ci, jnp.int32), jnp.asarray(pi, jnp.int32),
                       jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(K))

    def f(x):
        return torch.as_tensor(x, dtype=dtype)

    tp = BAProblem(f(R), f(t), f(pts), torch.as_tensor(ci),
                   torch.as_tensor(pi), f(uv), torch.as_tensor(mask), f(K))
    return jp, tp


def _jax_accepts(prob, iters, damping, huber):
    """The JAX solver's accept pattern: one more iteration either moves
    the poses, or leaves them exactly where they were."""
    out, prev = [], None
    for n in range(iters + 1):
        R = np.asarray(jgn.ba_solve(prob, iters=n, damping=damping,
                                    huber_delta=huber)[0])
        if prev is not None:
            out.append(not np.array_equal(R, prev))
        prev = R
    return out


KINDS = {
    "perfect": dict(kw={}, iters=3, damping=1e-4, huber=0.0),
    "noisy_init": dict(kw=dict(pose_noise=0.02, pt_noise=0.05, seed=1),
                       iters=12, damping=1e-4, huber=0.0),
    "pixel_noise": dict(kw=dict(noise_px=0.5, pose_noise=0.01,
                                pt_noise=0.02, seed=2),
                        iters=12, damping=1e-4, huber=0.0),
    "huber_outliers": dict(kw=dict(noise_px=0.5, pose_noise=0.01,
                                   pt_noise=0.02, outliers=0.05, seed=3),
                           iters=8, damping=1e-2, huber=2.0),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_ba_solve_matches_jax(kind):
    k = KINDS[kind]
    jp, tp = _both(make_problem(**k["kw"]))
    Rj, tj, pj, ej = (np.asarray(x) for x in jgn.ba_solve(
        jp, iters=k["iters"], damping=k["damping"], huber_delta=k["huber"]))
    R, t, p, e = ba_solve(tp, iters=k["iters"], damping=k["damping"],
                          huber_delta=k["huber"])
    _assert_same_solution((R, t, p), (Rj, tj, pj))
    assert abs(float(e) - float(ej)) <= 1e-3
    got = lm_iterations(tp, k["iters"], k["damping"],
                        huber_delta=k["huber"])[3].tolist()
    want = _jax_accepts(jp, k["iters"], k["damping"], k["huber"])
    n = ([g and w for g, w in zip(got, want)] + [False]).index(False)
    assert got == want or n >= 3, (got, want)
    err0 = float(reprojection_errors(tp).sum() / tp.mask.sum())
    if kind == "perfect":
        assert float(e) < 1e-2
    else:
        assert float(e) < err0      # the refinement was real


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reprojection_errors_match_jax(kind):
    jp, tp = _both(make_problem(**KINDS[kind]["kw"]))
    got = reprojection_errors(tp).numpy()
    np.testing.assert_allclose(got, np.asarray(jgn.reprojection_errors(jp)),
                               rtol=0, atol=1e-4)
    assert (got[~tp.mask.numpy()] == 0).all()


def test_ba_solve_float64_and_free_gauge():
    """float64 problems solve in float64; without the gauge fix the
    damping alone keeps the system solvable and camera 0 moves."""
    arrays = make_problem(pose_noise=0.02, pt_noise=0.05, seed=1)
    _, tp32 = _both(arrays)
    _, tp64 = _both(arrays, torch.float64)
    R, t, p, e = ba_solve(tp64, iters=12)
    assert R.dtype == t.dtype == p.dtype == e.dtype == torch.float64
    e32 = ba_solve(tp32, iters=12)[3]
    assert float(e) < 0.05 and abs(float(e) - float(e32)) < 1e-3
    assert torch.equal(R[0], tp64.R[0])
    R_free = ba_solve(tp64, iters=12, fix_first_cam=False)[0]
    assert not torch.equal(R_free[0], tp64.R[0])


def test_exp_so3_small_angle_branch():
    phi = torch.tensor([[0.0, 0.0, 0.0], [1e-6, -2e-6, 0.5e-6],
                        [0.1, -0.2, 0.3]], dtype=torch.float64)
    got = tgn._exp_so3(phi)
    for g, v in zip(got, phi):
        np.testing.assert_allclose(g.numpy(), rodrigues(v.numpy()),
                                   rtol=0, atol=1e-12)
    assert torch.equal(got[0], torch.eye(3, dtype=torch.float64))


def _chain_tracks_naive(match_idx, match_ok):
    """tests/test_vo_ba.py's per-(frame, slot) loop, the semantics
    oracle."""
    t, k = match_idx.shape
    track_of = -np.ones((t, k), np.int64)
    tracks = []
    for i in range(1, t):
        for slot in range(k):
            if not match_ok[i, slot]:
                continue
            j = int(match_idx[i, slot])
            tid = track_of[i - 1, slot]
            if tid < 0:
                tid = len(tracks)
                tracks.append([(i - 1, slot)])
                track_of[i - 1, slot] = tid
            if track_of[i, j] < 0:
                tracks[tid].append((i, j))
                track_of[i, j] = tid
    return [tr for tr in tracks if len(tr) >= 2]


@pytest.mark.parametrize("t,k,seed", [(3, 2, None), (12, 40, 0),
                                      (12, 40, 1), (1200, 1000, 2)])
def test_chain_tracks_matches_jax(t, k, seed):
    if seed is None:
        idx = np.array([[0, 0], [0, 1], [0, 0]])
        ok = np.array([[False, False], [True, True], [True, False]])
    else:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, k, (t, k))
        ok = rng.random((t, k)) < (0.5 if t > 100 else 0.6)
    got = tvb.chain_tracks(idx, ok)
    assert got == jvb.chain_tracks(idx, ok)
    if t < 100:
        assert got == _chain_tracks_naive(idx, ok)
    assert len(got) > 0
    assert tvb.chain_tracks(idx, np.zeros_like(ok)) == []


_SPLAT = SyntheticSplatSequenceDataset(5, 256, 0, 900)


def _splat_window(seed, frames=5, k=400, noise=0.5, wrong=0.05):
    """The splat scene's blobs projected into `frames` frames with `noise`
    px of noise, one keypoint slot per blob in every frame, the slots
    shuffled per frame; matches between consecutive frames, 15% of them
    dropped and `wrong` of them sent to a random slot; world-to-camera
    poses perturbed from the truth after frame 0. Returns (kpts_px [T, k,
    2] float32, match_idx [T, k], match_ok [T, k], R_w2c [T,3,3], t_w2c
    [T,3], K)."""
    rng = np.random.default_rng(seed)
    Kc = _SPLAT.base.K.astype(np.float32)
    X = _SPLAT.X[rng.permutation(len(_SPLAT.X))[:k]]
    perm = np.stack([rng.permutation(k) for _ in range(frames)])
    kpts = np.zeros((frames, k, 2), np.float32)
    Rs, ts = [], []
    for f in range(frames):
        T = _SPLAT.poses_cam[f]
        Xc = X @ T[:3, :3].T + T[:3, 3]
        uv = Xc[:, :2] / Xc[:, 2:] * Kc[0, 0] + Kc[0, 2]
        kpts[f, perm[f]] = uv + rng.normal(0, noise, uv.shape)
        R, t = T[:3, :3], T[:3, 3]
        if f:
            R = rodrigues(rng.normal(0, 0.01, 3)) @ R
            t = t + rng.normal(0, 0.03, 3)
        Rs.append(R)
        ts.append(t)
    idx = np.zeros((frames, k), np.int64)
    ok = np.zeros((frames, k), bool)
    for f in range(1, frames):
        idx[f, perm[f - 1]] = perm[f]
        ok[f] = rng.random(k) > 0.15
        bad = rng.random(k) < wrong
        idx[f, bad] = rng.integers(0, k, int(bad.sum()))
    return kpts, idx, ok, np.stack(Rs), np.stack(ts), Kc


def _jax_unpadded(built):
    prob, n = built
    keep = np.asarray(prob.mask)
    return {"R": np.asarray(prob.R), "t": np.asarray(prob.t),
            "points": np.asarray(prob.points)[:n],
            "cam_idx": np.asarray(prob.cam_idx)[keep],
            "pt_idx": np.asarray(prob.pt_idx)[keep],
            "uv": np.asarray(prob.uv)[keep], "K": np.asarray(prob.K)}


@pytest.mark.parametrize("seed", [0, 1])
def test_build_ba_problem_matches_jax_unpadded(seed):
    kpts, idx, ok, R, t, Kc = _splat_window(seed)
    tracks = tvb.chain_tracks(idx, ok)
    want = _jax_unpadded(jvb.build_ba_problem(kpts, tracks, R, t, Kc))
    prob = tvb.build_ba_problem(kpts, tracks, R, t, Kc, device="cpu")
    for name, w in want.items():
        g = getattr(prob, name).numpy()
        assert g.shape == w.shape and np.array_equal(g, w), name
    assert bool(prob.mask.all()) and len(prob.mask) == len(prob.uv)
    assert prob.cam_idx.dtype == prob.pt_idx.dtype == torch.int64
    assert tvb.build_ba_problem(kpts, [], R, t, Kc, device="cpu") is None
    assert tvb.build_ba_problem(kpts, tracks[:7], R, t, Kc,
                                device="cpu") is None


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_window_matches_jax(seed):
    kpts, idx, ok, R, t, Kc = _splat_window(seed)
    tracks = tvb.chain_tracks(idx, ok)
    want = jvb.refine_window(kpts, tracks, R, t, Kc)
    got = tvb.refine_window(kpts, tracks, R, t, Kc, device="cpu")
    assert got[2].shape == want[2].shape
    _assert_same_solution(got[:3], want[:3])
    assert abs(got[3] - want[3]) <= 1e-3 and abs(got[4] - want[4]) <= 1e-3
    assert got[4] < got[3]
    # the gate: the wrong matches' observations are out
    prob, err0 = tvb.gate_window(tvb.build_ba_problem(
        kpts, tracks, R, t, Kc, device="cpu"))
    assert 0 < int((~prob.mask).sum()) and abs(float(err0) - got[3]) == 0


def test_refine_window_mesh_raises():
    """A mesh that is not a parallel.mesh.Mesh raises; a one-rank Mesh
    is the one-rank solve (the distributed one on several ranks:
    tests/test_torch_parallel_ba.py)."""
    from keypoint_bench_tpu_torch.parallel.mesh import Mesh
    kpts, idx, ok, R, t, Kc = _splat_window(0)
    tracks = tvb.chain_tracks(idx, ok)
    with pytest.raises(TypeError, match="parallel"):
        tvb.refine_window(kpts, tracks, R, t, Kc, mesh=object(),
                          device="cpu")
    got = tvb.refine_window(kpts, tracks, R, t, Kc,
                            mesh=Mesh.single("cpu"), device="cpu")
    want = tvb.refine_window(kpts, tracks, R, t, Kc, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
