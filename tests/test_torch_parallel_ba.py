"""The distributed Schur BA, `refine_window(mesh=...)`, the VO runner's
`ba_distributed` and the sequence-sharded VO solves on the CPU, against
the JAX package on the conftest's 8-device mesh (mirrors
tests/test_ba_distributed.py, test_vo_ba.py's mesh case and
test_vo_sharded.py), ranks as threads over gloo (world sizes 1, 2, 4).

Tolerances: the partition is array-equal to JAX's. The solutions are
compared after the free scale about camera 0 (`chip_smoke.gauge_gap`, as
tests/test_torch_ba.py compares them): rotations, camera centres and
points within 1e-4, mean errors within 1e-3 px; a distributed solve
differs from the one-rank `ba_solve` only in the order of its float sums
(one rank: bit-equal). Every rank returns the same solution. The VO pair
solves are fed JAX's draws; the two packages' float32 raw-coordinate
8-point solves part on noisy pairs (tests/test_torch_vo.py), so as
test_vo_sharded.py does they are held to the ground truth: `ok` equal,
median translation-direction error under 15 degrees on both sides and
within 5 degrees of each other; world sizes 1, 2 and 4 bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ba.distributed import \
    ba_solve_distributed as jax_ba_distributed
from keypoint_bench_tpu.ba.distributed import \
    partition_problem as jax_partition
from keypoint_bench_tpu.geometry import ransac as jr
from keypoint_bench_tpu.parallel.mesh import make_mesh
from keypoint_bench_tpu.parallel.vo_sharded import \
    sharded_vo_pair_solves as jax_vo_solves
from keypoint_bench_tpu.tasks import vo_ba as jvb
from keypoint_bench_tpu_torch.ba import ba_solve, reprojection_errors
from keypoint_bench_tpu_torch.ba.distributed import (ba_solve_distributed,
                                                     gather_points,
                                                     partition_problem)
from keypoint_bench_tpu_torch.datasets.synthetic import \
    SyntheticSplatSequenceDataset
from keypoint_bench_tpu_torch.parallel import vo_sharded as tvs
from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.tasks import vo_ba as tvb
from tests.test_torch_ba import (KINDS, _assert_same_solution, _both,
                                 _splat_window, make_problem)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _solution(prob, R, t, pts):
    return (np.asarray(R), np.asarray(t), np.asarray(pts))


def _mean_err(prob, R, t, pts):
    from dataclasses import replace
    e = reprojection_errors(replace(prob, R=R, t=t, points=pts))
    return float(e.sum() / prob.mask.sum())


@pytest.mark.parametrize("n_shards", [3, 4])
def test_partition_matches_jax_and_roundtrips(n_shards):
    jp, tp = _both(make_problem(C=3, P=17, seed=4))
    got, meta = partition_problem(tp, n_shards)
    want, jmeta = jax_partition(jp, n_shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert meta["p_local"] == jmeta["p_local"]
    assert torch.equal(gather_points(got[0], meta, 17), tp.points)
    assert int(got[4].sum()) == int(tp.mask.sum())


@pytest.mark.parametrize("kind", ["noisy_init", "huber_outliers"])
def test_distributed_matches_jax_and_one_rank(kind):
    """test_ba_distributed.py's problem (noisy start, 5 cameras, 48
    points), and tests/test_torch_ba.py's Huber problem with outliers."""
    if kind == "noisy_init":
        arrays = make_problem(C=5, P=48, pose_noise=0.02, pt_noise=0.05,
                              seed=3)
        iters, damping, huber = 8, 1e-4, 0.0
    else:
        arrays = make_problem(**KINDS[kind]["kw"])
        iters, damping, huber = (KINDS[kind][k] for k in (
            "iters", "damping", "huber"))
    jp, tp = _both(arrays)
    kw = dict(iters=iters, damping=damping, huber_delta=huber)
    R1, t1, p1, e1 = ba_solve(tp, **kw)
    jR, jt, jpts, jmeta = jax_ba_distributed(make_mesh(n_data=8), jp, **kw)
    from keypoint_bench_tpu.ba.distributed import gather_points as jgather
    want = (np.asarray(jR), np.asarray(jt),
            jgather(jpts, jmeta, tp.points.shape[0]))
    for n in (1, 2, 4):
        outs = thread_ranks(lambda mesh: ba_solve_distributed(
            mesh, tp, **kw), n, device="cpu")
        R, t, s_pts, meta = outs[0]
        pts = gather_points(s_pts, meta, tp.points.shape[0])
        for o in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(o[:3], outs[0][:3]))
        if n == 1:
            assert torch.equal(R, R1) and torch.equal(pts, p1)
        got = _solution(tp, R, t, pts)
        _assert_same_solution(got, _solution(tp, R1, t1, p1))
        _assert_same_solution(got, want)
        assert abs(_mean_err(tp, R, t, pts) - float(e1)) <= 1e-3


def test_refine_window_mesh_matches_jax():
    kpts, idx, ok, R, t, Kc = _splat_window(0)
    tracks = tvb.chain_tracks(idx, ok)
    want = jvb.refine_window(kpts, tracks, R, t, Kc, mesh=make_mesh(8))
    one = tvb.refine_window(kpts, tracks, R, t, Kc, device="cpu")
    for n in (2, 4):
        outs = thread_ranks(lambda mesh: tvb.refine_window(
            kpts, tracks, R, t, Kc, mesh=mesh, device="cpu"), n, device="cpu")
        got = outs[0]
        for o in outs[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(o, got))
        assert got[2].shape == want[2].shape == one[2].shape
        _assert_same_solution(got[:3], want[:3])
        _assert_same_solution(got[:3], one[:3])
        assert got[3] == one[3] and abs(got[3] - want[3]) <= 1e-3
        assert abs(got[4] - want[4]) <= 1e-3 and got[4] < got[3]


def test_vo_runner_ba_distributed(tmp_path):
    """task_params.ba_distributed over 2 ranks lands on the one-rank
    windowed BA (test_vo_ba.py's mesh case)."""
    def cfg(dist, out):
        return EvalConfig(
            model_type="Alike", task_type="visual_odometer",
            data_params={"type": "synthetic_splat_sequence",
                         "num_frames": 5, "image_size": 256},
            extractor_params={"nms_dist": 4, "threshold": 0,
                              "border_dist": 8, "top_k": 300,
                              "min_score": 0.0},
            matcher_params={"type": "brute_force",
                            "brute_force_params": {"max_distance": 5.0}},
            task_params={"pipelined": True, "ba_refine": True,
                         "ba_distributed": dist},
            output_dir=str(tmp_path / out), seed=0)

    res1 = Evaluator(cfg(False, "one"), "cpu").run()
    res2 = thread_ranks(lambda mesh: Evaluator(cfg(True, "two"), "cpu",
                                               mesh=mesh).run(), 2,
                        device="cpu")
    for r in res2:
        np.testing.assert_array_equal(r["ba_R_w2c"], res2[0]["ba_R_w2c"])
    r = res2[0]
    assert r["ba_tracks"] == res1["ba_tracks"]
    assert r["ba_reproj_after"] < r["ba_reproj_before"]
    assert abs(r["ba_reproj_after"] - res1["ba_reproj_after"]) \
        < 0.05 * max(res1["ba_reproj_after"], 0.1)
    np.testing.assert_allclose(r["ba_R_w2c"], res1["ba_R_w2c"], atol=2e-3)
    assert (tmp_path / "two" / "trajectory.txt").exists()


@pytest.fixture(scope="module")
def splat_frames():
    """8 frames of the splat sequence at 256^2 through the port's
    detection (Alike, K = 500): kpts, valids, dense maps, the dataset."""
    t_frames = 8
    ds = SyntheticSplatSequenceDataset(t_frames, 256)
    ev = Evaluator(EvalConfig(
        model_type="Alike", task_type="visual_odometer",
        data_params={"type": "synthetic_splat_sequence"},
        extractor_params={"nms_dist": 4, "threshold": 0, "border_dist": 8,
                          "top_k": 500, "min_score": 0.0},
        output_dir="unused"), "cpu")
    det = [ev.detect(np.asarray(ds[i]["image0"], np.float32))
           for i in range(t_frames)]
    kpts, valids, descs = (torch.stack([d[j] for d in det])
                           for j in (2, 3, 1))
    return kpts, valids, descs, ds


def _angular_errors(ds, t_est):
    errs = []
    for i in range(1, len(t_est)):
        T_rel = ds.poses_cam[i] @ np.linalg.inv(ds.poses_cam[i - 1])
        gt = T_rel[:3, 3] / np.linalg.norm(T_rel[:3, 3])
        e = t_est[i] / max(np.linalg.norm(t_est[i]), 1e-9)
        errs.append(np.degrees(np.arccos(min(abs(float(e @ gt)), 1.0))))
    return np.asarray(errs)


def test_sharded_vo_matches_jax_and_world_sizes(splat_frames, monkeypatch):
    kpts, valids, descs, ds = splat_frames
    t_frames = len(kpts)
    keys = jax.random.split(jax.random.key(0), t_frames)
    fx, cx, cy = ds[0]["fx"], ds[0]["cx"], ds[0]["cy"]

    def jax_draws(mask, seeds, n_hyp, size):
        return torch.stack([torch.from_numpy(np.array(jr._sample_minimal(
            keys[int(s)], jnp.asarray(mask[j].numpy()), n_hyp,
            size))).long() for j, s in enumerate(seeds)])

    monkeypatch.setattr(tvs, "pair_samples", jax_draws)
    R_j, t_j, ok_j = jax_vo_solves(
        make_mesh(n_data=8), jnp.asarray(kpts.numpy()),
        jnp.asarray(valids.numpy()), jnp.asarray(descs.numpy()), keys,
        fx, cx, cy, 256, 256, n_hyp=4096)

    def fn(mesh):
        return tvs.sharded_vo_pair_solves(mesh, kpts, valids, descs,
                                          list(range(t_frames)), fx, cx, cy,
                                          256, 256, n_hyp=4096)

    one = thread_ranks(fn, 1, device="cpu")[0]
    for n in (2, 4):
        for out in thread_ranks(fn, n, device="cpu"):
            assert all(torch.equal(a, b) for a, b in zip(out, one))
    R, t, ok = one
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    okm = ok.numpy()[1:]
    err_t = _angular_errors(ds, t.numpy())[okm]
    err_j = _angular_errors(ds, np.asarray(t_j))[okm]
    assert np.median(err_t) < 15.0, err_t
    assert np.median(err_j) < 15.0, err_j
    assert abs(np.median(err_t) - np.median(err_j)) < 5.0


def test_sharded_vo_takes_keypoint_descriptors(splat_frames):
    """[T, K, D] descriptors sampled at the keypoints give the dense
    maps' solves."""
    from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
    kpts, valids, descs, ds = splat_frames
    seeds = list(range(len(kpts)))
    args = (ds[0]["fx"], ds[0]["cx"], ds[0]["cy"], 256, 256)
    sampled = sample_at_points(descs, kpts)

    def fn(mesh):
        return (tvs.sharded_vo_pair_solves(mesh, kpts, valids, descs, seeds,
                                           *args, n_hyp=256),
                tvs.sharded_vo_pair_solves(mesh, kpts, valids, sampled,
                                           seeds, *args, n_hyp=256))

    dense, sparse = thread_ranks(fn, 2, device="cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(dense, sparse))
