"""Loop closure in the PyTorch port (tasks/loop_closure.py) against the JAX
package's, on the CPU.

The port matches every frame pair in one batched `mutual_nn_match` (kernel
D on the card) where JAX makes one call per pair; each batch row is
independent, so the batch equals the per-pair loop bit for bit. The
scaled path's randomness is fed JAX's own draws: the minimal samples that
`_sample_minimal` draws from JAX's split keys, and the LK jitter angles of
`jax.random.key(i)` per frame. With the same inputs the two packages find
the same closures (i, j, n): R within 1e-6, t within 1e-4 (bit-equal
seen on the geometric fixture), and the pose graph within 1e-4.

Fixtures: tests/test_loop_closure.py's geometric fixture (exact
projections, unique descriptors) and one splat out-and-back sequence at
128^2 (7 frames, ALIKE-t through the port's runner on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keypoint_bench_tpu.geometry.ransac as jr
import keypoint_bench_tpu.tasks.loop_closure as jl
from keypoint_bench_tpu.ops.matching import mutual_nn_match as jax_mutual_nn
from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
from keypoint_bench_tpu_torch.ops.matching import mutual_nn_match
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.tasks import loop_closure as tl
from test_loop_closure import (_ate, _geometric_loop_fixture, _loop_frames,
                               _noisy_odometry)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_draws(seed=0, n_hyp=1024):
    """draw_samples as JAX's detect_loop_closures_scaled draws them: one
    split of its key per candidate, in pair order."""
    state = {"key": jax.random.key(seed)}

    def draws(masks):
        out = []
        for m in masks.cpu().numpy():
            state["key"], sub = jax.random.split(state["key"])
            out.append(np.asarray(jr._sample_minimal(sub, jnp.asarray(m),
                                                     n_hyp, 8)))
        return torch.from_numpy(np.stack(out)).long()
    return draws


def _jax_angles(t, k):
    """The LK jitter angles JAX's scaled path takes for frame i."""
    return np.stack([np.asarray(jax.random.normal(jax.random.key(i), (k,))
                                * 6.28) for i in range(t)])


def _odometry(poses):
    R_rel, t_rel, scales = [np.eye(3)], [np.zeros(3)], [0.0]
    for i in range(1, len(poses)):
        T = poses[i] @ np.linalg.inv(poses[i - 1])
        s = np.linalg.norm(T[:3, 3])
        scales.append(s)
        R_rel.append(T[:3, :3])
        t_rel.append(T[:3, 3] / max(s, 1e-9))
    return np.stack(R_rel), np.stack(t_rel), scales


def _torch_inputs(descs, valids):
    return ([torch.tensor(np.asarray(d)) for d in descs],
            [torch.tensor(np.asarray(v)) for v in valids])


def _assert_same_closures(got, ref, t_tol=1e-4):
    assert [(c[0], c[1], c[-1]) for c in got] == \
        [(c[0], c[1], c[-1]) for c in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[2], np.asarray(r[2]), atol=1e-6)
        if len(r) == 5:
            np.testing.assert_allclose(g[3], np.asarray(r[3]), atol=t_tol)


@pytest.mark.parametrize("max_distance", [5.0, 1.0])
def test_batched_pair_matching_equals_per_pair_loop(max_distance):
    """match_frame_pairs (one call over [P, K, D]) against the port's and
    JAX's mutual_nn_match pair by pair: indices and masks equal."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(64, 16)).astype(np.float32)
    descs = [base + rng.normal(0, 0.3, base.shape).astype(np.float32)
             for _ in range(7)]
    valids = [rng.random(64) > 0.2 for _ in range(7)]
    pairs = tl.closure_pairs(7, 3) + [(i, i + 1) for i in range(6)]
    nn, ok = tl.match_frame_pairs(*_torch_inputs(descs, valids), pairs,
                                  max_distance)
    assert nn.shape == ok.shape == (len(pairs), 64)
    assert ok.any() and not ok.all()
    for p, (i, j) in enumerate(pairs):
        nn_t, ok_t = mutual_nn_match(torch.from_numpy(descs[i]),
                                     torch.from_numpy(descs[j]),
                                     torch.from_numpy(valids[i]),
                                     torch.from_numpy(valids[j]),
                                     max_distance)
        nn_j, ok_j = jax_mutual_nn(jnp.asarray(descs[i]),
                                   jnp.asarray(descs[j]),
                                   jnp.asarray(valids[i]),
                                   jnp.asarray(valids[j]), max_distance)
        np.testing.assert_array_equal(ok[p], ok_t.numpy())
        np.testing.assert_array_equal(ok[p], np.asarray(ok_j))
        np.testing.assert_array_equal(nn[p][ok[p]], nn_t.numpy()[ok[p]])
        np.testing.assert_array_equal(nn[p][ok[p]], np.asarray(nn_j)[ok[p]])


@pytest.mark.parametrize("per_call", [1, 4, 7])
def test_pair_matching_in_chunks_equals_one_call(monkeypatch, per_call):
    """match_frame_pairs in calls of `per_call` pairs (the memory bound of
    long sequences) equals the one call over every pair."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(48, 16)).astype(np.float32)
    descs = [base + rng.normal(0, 0.3, base.shape).astype(np.float32)
             for _ in range(6)]
    valids = [rng.random(48) > 0.2 for _ in range(6)]
    pairs = tl.closure_pairs(6, 2)
    nn1, ok1 = tl.match_frame_pairs(*_torch_inputs(descs, valids), pairs)
    monkeypatch.setattr(tl, "MATCH_PAIRS_PER_CALL", per_call)
    nn, ok = tl.match_frame_pairs(*_torch_inputs(descs, valids), pairs)
    assert ok1.any()
    np.testing.assert_array_equal(ok, ok1)
    np.testing.assert_array_equal(nn, nn1)


def test_closure_pairs_order_and_count():
    assert tl.closure_pairs(6, 4) == [(0, 4), (0, 5), (1, 5)]
    # chip_smoke's 31-frame out-and-back at gap 4: 378 pairs
    assert len(tl.closure_pairs(31, 4)) == 27 * 28 // 2
    assert tl.closure_pairs(3, 4) == []


def test_strong_closures_match_jax_on_geometric_fixture():
    """A near-coincident revisit (the last frame 1 cm from frame 0): the
    zero-translation Kabsch edge, as JAX finds it."""
    kpts_px, valids, descs, poses, K = _geometric_loop_fixture(
        closure_offset=(0.01, 0.0, 0.0))
    ref = jl.detect_loop_closures(descs, valids, kpts_px, K, min_gap=4,
                                  min_matches=80)
    got = tl.detect_loop_closures(*_torch_inputs(descs, valids), kpts_px, K,
                                  min_gap=4, min_matches=80)
    assert (0, 5) in [(c[0], c[1]) for c in got]
    _assert_same_closures(got, ref)
    # no closure without enough matches
    assert tl.detect_loop_closures(*_torch_inputs(descs, valids), kpts_px,
                                   K, min_gap=4, min_matches=201) == []


@pytest.fixture(scope="module")
def geometric():
    kpts_px, valids, descs, poses, K = _geometric_loop_fixture()
    R_rel, t_rel, scales = _odometry(poses)
    ref = jl.detect_loop_closures_scaled(
        descs, valids, kpts_px, K, R_rel, t_rel, scales, jax.random.key(0),
        min_gap=4, min_matches=60)
    got = tl.detect_loop_closures_scaled(
        *_torch_inputs(descs, valids), kpts_px, K, R_rel, t_rel, scales,
        None, min_gap=4, min_matches=60, draw_samples=_jax_draws())
    return poses, (R_rel, t_rel, scales), got, ref


def test_scaled_closures_match_jax_with_its_draws(geometric):
    _, _, got, ref = geometric
    _assert_same_closures(got, ref)


def test_scaled_closure_metric_translation(geometric):
    """tests/test_loop_closure.py's metric check on the port: the revisit's
    translation within 0.05, its rotation within 2 degrees."""
    poses, _, got, _ = geometric
    scaled = {(c[0], c[1]): c for c in got if np.linalg.norm(c[3]) > 0.05}
    j = len(poses) - 1
    assert (0, j) in scaled, [(c[0], c[1]) for c in got]
    _, _, R, tv, _ = scaled[(0, j)]
    T_gt = poses[j] @ np.linalg.inv(poses[0])
    assert np.linalg.norm(tv - T_gt[:3, 3]) < 0.05, (tv, T_gt[:3, 3])
    cos = np.clip((np.trace(R.T @ T_gt[:3, :3]) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)) < 2.0


def test_scaled_closures_draw_from_a_generator(geometric):
    """Without given draws the samples come from the generator: the same
    closures on this exact fixture (every sample fits it)."""
    kpts_px, valids, descs, _, K = _geometric_loop_fixture()
    _, odo, got, _ = geometric
    drawn = tl.detect_loop_closures_scaled(
        *_torch_inputs(descs, valids), kpts_px, K, *odo,
        torch.Generator().manual_seed(0), min_gap=4, min_matches=60)
    _assert_same_closures(drawn, got, t_tol=1e-3)


@pytest.mark.parametrize("iters", [0, 15])
def test_optimize_with_closures_matches_jax(geometric, iters):
    poses, _, got, ref = geometric
    R_rel, t_rel, scales = _noisy_odometry(poses, rot_noise=0.02,
                                           dir_noise=0.05)
    Rt, tt, res = tl.optimize_with_closures(R_rel, t_rel, scales, got,
                                            iters=iters, device="cpu")
    Rj, tj, resj = jl.optimize_with_closures(R_rel, t_rel, scales, ref,
                                             iters=iters)
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)
    np.testing.assert_allclose(tt, tj, atol=1e-4)
    assert abs(res - resj) < 1e-4


@pytest.fixture(scope="module")
def splat():
    """tests/test_loop_closure.py's out-and-back splat sequence at 128^2
    (n_mid 3: 7 frames), ALIKE-t through the port's runner on the CPU."""
    frames, poses, K = _loop_frames(n_mid=3, image_size=128)
    ev = Evaluator(EvalConfig(
        model_type="Alike", task_type="visual_odometer",
        data_params={"type": "synthetic_splat_sequence"},
        extractor_params={"nms_dist": 4, "threshold": 0, "border_dist": 8,
                          "top_k": 400, "min_score": 0.0},
        output_dir="unused"), "cpu")
    kpts, valids, descs = [], [], []
    for img in frames:
        _, d, k, v = ev.detect(np.asarray(img, np.float32))
        kpts.append(k[:, :2].numpy() * 127.0)
        valids.append(v)
        descs.append(sample_at_points(d, k))
    return frames, poses, np.asarray(K), kpts, valids, descs


def test_splat_loop_closure_reduces_drift(splat):
    """tests/test_loop_closure.py's drift test on the port at 128^2: the
    closures equal JAX's on the same features, the pose graph equals
    JAX's within 1e-4, and it cuts the ATE of the noisy chain below 0.8x."""
    frames, poses, K, kpts, valids, descs = splat
    got = tl.detect_loop_closures(descs, valids, kpts, K, min_gap=4,
                                  min_matches=80)
    ref = jl.detect_loop_closures([jnp.asarray(d.numpy()) for d in descs],
                                  [jnp.asarray(v.numpy()) for v in valids],
                                  kpts, K, min_gap=4, min_matches=80)
    assert (0, len(frames) - 1) in [(c[0], c[1]) for c in got]
    _assert_same_closures(got, ref)
    R_rel, t_rel, scales = _noisy_odometry(poses)
    R0, t0, _ = tl.optimize_with_closures(R_rel, t_rel, scales, [], iters=0,
                                          device="cpu")
    R1, t1, res = tl.optimize_with_closures(R_rel, t_rel, scales, got,
                                            iters=15, device="cpu")
    Rj, tj, resj = jl.optimize_with_closures(R_rel, t_rel, scales, ref,
                                             iters=15)
    np.testing.assert_allclose(R1, Rj, atol=1e-4)
    np.testing.assert_allclose(t1, tj, atol=1e-4)
    assert abs(res - resj) < 1e-4
    a0, a1 = _ate(R0, t0, poses), _ate(R1, t1, poses)
    assert a1 < 0.8 * a0, (a0, a1)


def test_splat_scaled_closures_with_images_match_jax(splat):
    """The scaled path with `images` (LK neighbour tracks, kernel F on the
    card) on the splat features, JAX's draws and angles fed in: the same
    closures, each inside tests/test_loop_closure.py's drift envelope."""
    frames, poses, K, kpts, valids, descs = splat
    R_rel, t_rel, scales = _noisy_odometry(poses, rot_noise=0.02,
                                           dir_noise=0.02)
    imgs = [np.asarray(f, np.float32) for f in frames]
    ref = jl.detect_loop_closures_scaled(
        [jnp.asarray(d.numpy()) for d in descs],
        [jnp.asarray(v.numpy()) for v in valids], kpts, K, R_rel, t_rel,
        scales, jax.random.key(0), min_gap=4, min_matches=60, images=imgs)
    calls = []

    def draws(masks):
        calls.append(masks.shape[0])
        return _jax_draws()(masks)

    got = tl.detect_loop_closures_scaled(
        descs, valids, kpts, K, R_rel, t_rel, scales, None, min_gap=4,
        min_matches=60, images=imgs, draw_samples=draws,
        angles=_jax_angles(len(frames), kpts[0].shape[0]))
    assert calls and calls[0] > 0      # the parallax candidates ran RANSAC
    _assert_same_closures(got, ref)
    for i, j, _, tv, _ in got:
        T = poses[j] @ np.linalg.inv(poses[i])
        assert np.linalg.norm(tv - T[:3, 3]) < 0.3 + 0.06 * (j - i) + 0.35
