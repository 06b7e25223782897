"""Pose-graph optimization in the PyTorch port (ba/pose_graph.py) against
the JAX package's `pgo_solve` on tests/test_pose_graph.py's circle graph
(noisy odometry and one exact closure), on the CPU in float32.

JAX takes the edge Jacobians with jax.jacfwd under vmap; the port writes
that forward-mode derivative out for all edges at once, held here against
torch.func.jacfwd under vmap of its own residual and against JAX's. It
sums the normal system in the JAX package's scatter order and solves the
same dense system with LAPACK: poses within 1e-5 after 0, 5 and 15
iterations (9.7e-7 seen)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ba import pose_graph as jpg
from keypoint_bench_tpu_torch.ba import pose_graph as tpg
from test_pose_graph import _make_circle_graph


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torch_graph(g, dtype=torch.float32):
    def t(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt)
    return tpg.PoseGraph(R=t(g.R), t=t(g.t), edge_i=t(g.edge_i, torch.long),
                         edge_j=t(g.edge_j, torch.long), meas_R=t(g.meas_R),
                         meas_t=t(g.meas_t), weight=t(g.weight))


@pytest.mark.parametrize("drift", [0.03, 0.0], ids=["drift", "exact"])
@pytest.mark.parametrize("iters", [0, 5, 15])
def test_pgo_solve_matches_jax(iters, drift):
    g, _, _ = _make_circle_graph(drift=drift)
    R, t, res = tpg.pgo_solve(_torch_graph(g), iters=iters)
    Rj, tj, resj = jpg.pgo_solve(g, iters=iters)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(float(res), float(resj), atol=1e-5)


def test_pgo_solve_damping_matches_jax():
    """optimize_with_closures' damping 1e-4."""
    g, _, _ = _make_circle_graph(seed=1)
    R, t, _ = tpg.pgo_solve(_torch_graph(g), iters=5, damping=1e-4)
    Rj, tj, _ = jpg.pgo_solve(g, iters=5, damping=1e-4)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)


def test_edge_jacobians_match_jax_jacfwd():
    """The per-edge residuals and jacfwd Jacobians of one linearization,
    against jax.jacfwd of the JAX residual on the same edges (1e-5)."""
    g, _, _ = _make_circle_graph()
    tg = _torch_graph(g)
    r, Ji, Jj = tpg._linearize(tg.R, tg.t, tg)
    zero6 = jnp.zeros(6)

    def per_edge(Ri, ti, Rj, tj, mR, mt, w):
        def f(di, dj):
            return jpg._edge_residual(Ri, ti, Rj, tj, mR, mt, di, dj)
        return (f(zero6, zero6) * w, jax.jacfwd(f, 0)(zero6, zero6) * w,
                jax.jacfwd(f, 1)(zero6, zero6) * w)

    want = jax.jit(jax.vmap(per_edge))(
        g.R[g.edge_i], g.t[g.edge_i], g.R[g.edge_j], g.t[g.edge_j],
        g.meas_R, g.meas_t, g.weight)
    for got, ref in zip((r, Ji, Jj), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_log_so3_matches_jax_near_and_far_from_identity():
    rng = np.random.default_rng(0)
    from keypoint_bench_tpu.ba.gauss_newton import _exp_so3 as jexp
    phis = np.concatenate([rng.normal(0, 1.0, (8, 3)),
                           rng.normal(0, 1e-4, (4, 3)), np.zeros((1, 3))])
    Rs = np.stack([np.asarray(jexp(jnp.asarray(p, jnp.float32)))
                   for p in phis])
    got = tpg._log_so3(torch.from_numpy(Rs)).numpy()
    want = np.stack([np.asarray(jpg._log_so3(jnp.asarray(R))) for R in Rs])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pgo_reduces_trajectory_error():
    """tests/test_pose_graph.py's drift test on the port: the closure
    redistributes the odometry drift, ATE halves or better."""
    g, _, ts_gt = _make_circle_graph()
    ate0 = np.linalg.norm(np.asarray(g.t) - ts_gt, axis=1).mean()
    _, tf, _ = tpg.pgo_solve(_torch_graph(g), iters=15)
    ate1 = np.linalg.norm(tf.numpy() - ts_gt, axis=1).mean()
    assert ate1 < 0.6 * ate0, (ate0, ate1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pgo_exact_measurements_zero_residual(dtype):
    g, _, _ = _make_circle_graph(drift=0.0)
    _, _, res = tpg.pgo_solve(_torch_graph(g, dtype), iters=5)
    assert res.dtype == dtype
    # the graph holds float32-rounded measurements (5.4e-8 left in float64)
    assert float(res) < (1e-5 if dtype == torch.float32 else 1e-6)


@pytest.mark.parametrize("drift", [0.03, 0.0], ids=["drift", "exact"])
def test_edge_jacobians_match_torch_jacfwd(drift):
    """`_linearize`'s Jacobians, written out, against torch.func.jacfwd
    under vmap of `_edge_residual` (the JAX package's method) on the same
    edges: within 1e-6 (float32), and 1e-12 in float64."""
    from torch.func import jacfwd, vmap
    g, _, _ = _make_circle_graph(drift=drift)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        tg = _torch_graph(g, dtype)
        r, Ji, Jj = tpg._linearize(tg.R, tg.t, tg)
        zero6 = torch.zeros(6, dtype=dtype)

        def per_edge(Ri, ti, Rj, tj, mR, mt, w):
            def f(di, dj):
                return tpg._edge_residual(Ri, ti, Rj, tj, mR, mt, di, dj)
            Ja, Jb = jacfwd(f, argnums=(0, 1))(zero6, zero6)
            return f(zero6, zero6) * w, Ja * w, Jb * w

        ei, ej = tg.edge_i, tg.edge_j
        want = vmap(per_edge)(tg.R[ei], tg.t[ei], tg.R[ej], tg.t[ej],
                              tg.meas_R, tg.meas_t, tg.weight)
        for got, ref in zip((r, Ji, Jj), want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol)
