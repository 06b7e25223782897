"""The VO slice end to end vs the JAX runner (CPU): `visual_odometer`
pipelined (brute force, with and without windowed BA) and pair by pair
(brute force, optical_flow at LK distance 0), on the splat sequence at
256^2, and `pipeline.vo_step`.

Both packages solve every pair's essential RANSAC on raw normalized
coordinates in float32, whose hypotheses are ill-conditioned: on the same
matches and the same minimal samples the two packages' LAPACK solves
reach other consensus sets in most pairs here (tests/test_torch_vo.py
holds the solve where they agree), and the chained end positions then
part by up to 0.46 over five frames. JAX's own batched solve, compiled
alone or inside the runner's graph (another fusion of the same float32
algebra), differs from itself by up to 7.3e-3 in a pair's unit t. So the
runner comparisons take JAX's `vo_pair_pose` as the pair solver on both
sides (`jax_pair_solver`, fed the port's matches and the keys the JAX
runner draws), or, pipelined, replay the JAX runner's own solves
(`jax_runner_solves`); everything around the solve is the port's. The
port's own solver runs in the other cases.

Tolerances: keypoints and matches are equal (ALIKE's features within
1e-5 and mutual NN on them), so `ba_tracks` is equal. Where the solves
are the same (replayed, or JAX's eager solve on equal inputs), `t_est`
and `R_est` agree within 1e-3 and the BA mean errors within 1e-3 px
(float32 LM in another summation order, tests/test_torch_ba.py). JAX's
batched solve compiled apart: `t_est` within 5e-3 (2.6e-3 measured).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu import runner as jrunner
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.tasks import vo as jvo
from keypoint_bench_tpu_torch import cli, pipeline
from keypoint_bench_tpu_torch import runner as trunner
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.pipeline import vo_step
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.tasks.trajectory import ate_rmse
from keypoint_bench_tpu_torch.weights import load_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 256
EP = {"nms_dist": 4, "threshold": 0, "border_dist": 8, "top_k": 300,
      "min_score": 0.0}


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


def _cfg(out, model="Alike_s2d", matcher="brute_force", frames=5, **tp):
    return dict(model_type=model, task_type="visual_odometer",
                data_params={"type": "synthetic_splat_sequence",
                             "num_frames": frames, "image_size": S},
                extractor_params=EP,
                matcher_params={"type": matcher,
                                "brute_force_params": {"max_distance": 5.0},
                                "optical_flow_params": {
                                    "distance": 0, "win_size": 11,
                                    "levels": 2, "interation": 8}},
                task_params=tp, output_dir=str(out), seed=0)


@pytest.fixture
def jax_pair_solver(monkeypatch):
    """The port's runner solves its pairs with JAX's vo_pair_pose on the
    keys the JAX runner draws from seed 0: one split per batched call,
    split again over its pairs; one per sequential pair, after the one
    that the JAX runner's LK spends (`lk_keys`). Records the sequential
    pairs' inputs."""
    state = {"key": jax.random.key(0), "lk_keys": 0, "inputs": []}

    def next_key():
        state["key"], k = jax.random.split(state["key"])
        return k

    batched = jax.jit(jax.vmap(jvo.vo_pair_pose,
                               in_axes=(0, 0, 0, None, None, None, 0)))

    def solve(p0, p1, mask, fx, cx, cy, generator, n_hyp=4096, **kw):
        f = [jnp.asarray(float(v), jnp.float32) for v in (fx, cx, cy)]
        a = [jnp.asarray(x.numpy()) for x in (p0, p1, mask)]
        if p0.dim() == 3:
            out = batched(*a, *f, jax.random.split(next_key(), p0.shape[0]))
        else:
            state["inputs"].append(tuple(np.asarray(x) for x in a))
            for _ in range(state["lk_keys"]):
                next_key()
            out = jvo.vo_pair_pose(*a, *f, next_key(), n_hyp=n_hyp)
        return tuple(torch.from_numpy(np.array(x)) for x in out)

    monkeypatch.setattr(pipeline, "vo_pair_pose", solve)
    monkeypatch.setattr(trunner, "vo_pair_pose", solve)
    return state


def _jax(cfg):
    return JaxEvaluator(JaxEvalConfig(**cfg)).run()


def _port(cfg):
    return Evaluator(EvalConfig(**cfg), "cpu").run()


def _assert_same_trajectory(got, ref, t_tol=1e-3):
    assert got["num_frames"] == ref["num_frames"]
    assert got["t_est"].shape == ref["t_est"].shape
    np.testing.assert_allclose(got["t_est"], ref["t_est"], rtol=0,
                               atol=t_tol)
    np.testing.assert_allclose(got["R_est"], ref["R_est"], rtol=0, atol=1e-3)


def _gt_positions(n):
    ds = get_dataset({"type": "synthetic_splat_sequence", "num_frames": n,
                      "image_size": S})
    return np.stack([p[:3, 3] for p in ds.poses])


@pytest.fixture
def jax_runner_solves(monkeypatch):
    """Replays the JAX runner's batched pair solves, read where it chains
    them (`chain_poses`), as the port's pipelined pair solver."""
    solves = []

    def chain(R, t, ok, scales):
        solves.append((R, t, ok))
        return jvo.chain_poses(R, t, ok, scales)

    def replay(p0, p1, mask, *args, **kw):
        R, t, ok = solves[-1]
        assert R.shape[0] == p0.shape[0]
        return (torch.tensor(R), torch.tensor(t),
                torch.zeros(len(ok), dtype=torch.long), torch.tensor(ok))

    monkeypatch.setattr(jrunner, "chain_poses", chain)
    monkeypatch.setattr(pipeline, "vo_pair_pose", replay)
    return solves


def test_pipelined_vo_with_and_without_ba_matches_jax_runner(
        highest, tmp_path, jax_runner_solves):
    ref = _jax(_cfg(tmp_path / "j", pipelined=True, ba_refine=True))
    got = _port(_cfg(tmp_path / "t", pipelined=True, ba_refine=True))
    assert len(jax_runner_solves) == 1
    _assert_same_trajectory(got, ref)
    assert sorted(got) == sorted(ref)
    assert got["ba_tracks"] == ref["ba_tracks"] > 100
    for k in ("ba_reproj_before", "ba_reproj_after"):
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])
    assert got["ba_reproj_after"] < got["ba_reproj_before"]
    pts = got["ba_points"]
    z0 = (got["ba_R_w2c"][0] @ pts.T + got["ba_t_w2c"][0][:, None])[2]
    assert (z0 > 0).mean() > 0.95
    plain = _port(_cfg(tmp_path / "n", pipelined=True))
    _assert_same_trajectory(plain, ref)
    assert not any(k.startswith("ba_") for k in plain)
    with open(tmp_path / "t" / "results.json") as f:
        assert json.load(f)["ba_tracks"] == got["ba_tracks"]


def test_pipelined_vo_jax_solver_on_the_ports_matches(
        highest, tmp_path, jax_pair_solver):
    """JAX's batched solver on the port's matches, with the JAX runner's
    keys: the JAX runner's trajectory (module docstring's tolerance)."""
    ref = _jax(_cfg(tmp_path / "j", pipelined=True))
    got = _port(_cfg(tmp_path / "t", pipelined=True))
    _assert_same_trajectory(got, ref, 5e-3)


def test_pipelined_vo_own_solver_keeps_the_tracks_and_the_ba_gates(
        tmp_path):
    """The port's own pair solver on the same matches: the tracks do not
    depend on it, and the BA gates of tests/test_vo_ba.py hold."""
    got = _port(_cfg(tmp_path, pipelined=True, ba_refine=True))
    assert got["ba_tracks"] == 372         # the JAX runner's count
    assert got["ba_reproj_after"] < got["ba_reproj_before"]
    pts = got["ba_points"]
    z0 = (got["ba_R_w2c"][0] @ pts.T + got["ba_t_w2c"][0][:, None])[2]
    assert (z0 > 0).mean() > 0.95
    assert np.isfinite(got["t_est"]).all()
    assert ate_rmse(got["t_est"][1:, :, 0], _gt_positions(5)) < 0.5


def test_pipelined_vo_sparse_desc_equals_dense(tmp_path):
    """Alike_s2d's sparse descriptors give the dense path's matches, so
    the port's own solver gives the same trajectory and tracks."""
    runs = [_port(_cfg(tmp_path / str(sd), pipelined=True, ba_refine=True,
                       sparse_desc=sd)) for sd in (True, False)]
    np.testing.assert_allclose(runs[0]["t_est"], runs[1]["t_est"], rtol=0,
                               atol=1e-3)
    assert runs[0]["ba_tracks"] == runs[1]["ba_tracks"]
    assert abs(runs[0]["ba_reproj_after"]
               - runs[1]["ba_reproj_after"]) <= 1e-3


@pytest.fixture
def jax_solver_inputs(monkeypatch):
    """The matched pixels and masks that the JAX runner's sequential
    path hands its pair solver, pair by pair."""
    calls = []

    def record(p0, p1, mask, *args):
        calls.append(tuple(np.asarray(x) for x in (p0, p1, mask)))
        return jvo.vo_pair_pose(p0, p1, mask, *args)

    monkeypatch.setattr(jrunner, "vo_pair_pose", record)
    return calls


@pytest.mark.parametrize("matcher,lk_keys,p1_px,end_gap", [
    ("brute_force", 0, 0.0, 1e-3), ("optical_flow", 1, 1e-2, 5e-2)])
def test_sequential_vo_matches_jax_runner(highest, tmp_path,
                                          jax_pair_solver, jax_solver_inputs,
                                          matcher, lk_keys, p1_px, end_gap):
    """The pair solver's inputs against the JAX runner's: keypoints equal,
    the matched (brute force) or tracked (LK, within its 5e-3 px per
    level) pixels, the masks equal (LK: the in-bounds filter). Brute
    force then gives the JAX trajectory within 1e-3. LK's tracks enter
    the ill-conditioned solve off by up to 1e-2 px, and the end position
    moves by up to 5% of the trajectory's length (2% measured)."""
    jax_pair_solver["lk_keys"] = lk_keys
    cfg = _cfg(tmp_path, "Alike", matcher, frames=4)
    ref = _jax(cfg)
    got = _port(cfg)
    assert len(jax_pair_solver["inputs"]) == len(jax_solver_inputs) == 4
    for (p0, p1, m), (q0, q1, n) in zip(jax_pair_solver["inputs"],
                                        jax_solver_inputs):
        assert np.array_equal(p0, q0) and np.array_equal(m, n)
        assert np.abs(p1 - q1)[m].max() <= p1_px
        assert m.sum() > 100
    assert sorted(got) == sorted(ref)
    assert got["t_est"].shape == (5, 3, 1)
    length = np.linalg.norm(np.diff(ref["t_est"][:, :, 0], axis=0),
                            axis=1).sum()
    assert length > 0.5                                 # it moved
    if end_gap < 1e-2:
        _assert_same_trajectory(got, ref)
    else:
        gap = np.linalg.norm(got["t_est"][-1] - ref["t_est"][-1])
        assert gap <= end_gap * length, (gap, length)


def test_vo_step_matches_the_pipelined_runner(tmp_path):
    """`vo_step` on the frames as uint8 and as float: the runner's result
    on the float frames, and the uint8 frames' within their rounding."""
    cfg = _cfg(tmp_path, pipelined=True, ba_refine=True)
    res = _port(cfg)
    ds = get_dataset(cfg["data_params"])
    items = [ds[i] for i in range(len(ds))]
    frames = np.stack([it["image0"] for it in items])
    scales = [float(np.linalg.norm(it["ground_truth"][:3, 3]
                                   - it["last_ground_truth"][:3, 3]))
              for it in items]
    K = np.array([[items[0]["fx"], 0, items[0]["cx"]],
                  [0, items[0]["fy"], items[0]["cy"]], [0, 0, 1]])
    model = get_model("Alike_s2d")(load_params("Alike_s2d"))
    dp = DetectParams(nms_dist=4, border_dist=8, top_k=300)
    out = vo_step(model, frames, K, scales, dp,
                  torch.Generator().manual_seed(0), ba_refine=True,
                  device="cpu")
    assert np.array_equal(out["t_est"], res["t_est"])
    assert out["ba_tracks"] == res["ba_tracks"]
    assert out["ba_reproj_after"] == res["ba_reproj_after"]
    assert out["kpts"].shape == (5, 300, 3) and out["nn01"].shape == (5, 300)
    assert out["R_rel"].shape == (5, 3, 3) and out["ok"].shape == (5,)
    out8 = vo_step(model, np.round(frames * 255).astype(np.uint8), K, scales,
                   dp, torch.Generator().manual_seed(0), device="cpu")
    assert out8["kpts"].shape == out["kpts"].shape
    for f in range(5):              # the same positions, maybe reordered
        a = {tuple(k) for k in out["kpts"][f, :, :2].tolist()}
        b = {tuple(k) for k in out8["kpts"][f, :, :2].tolist()}
        assert len(a & b) >= 0.9 * len(a)
    # given samples replace the generator's draws
    samples = torch.zeros((5, 16, 8), dtype=torch.long)
    samples[..., :] = torch.arange(8)
    given = vo_step(model, frames, K, scales, dp, None, n_hyp=16,
                    samples=samples, device="cpu")
    assert given["R_rel"].shape == (5, 3, 3)


@pytest.mark.parametrize("change,exc,what", [
    ({"task_params": {"pipelined": True, "ba_refine": True,
                      "ba_distributed": True}}, NotImplementedError,
     "ba_distributed")])
def test_vo_runner_raises(tmp_path, change, exc, what):
    cfg = {**_cfg(tmp_path, frames=2), **change}
    if what == "ba_distributed":
        # ported since: the window refines with the distributed Schur
        # solver over the Evaluator's ranks (one here, where it is the
        # one-rank solver; tests/test_torch_parallel_ba.py holds it on 2)
        res = Evaluator(EvalConfig(**cfg), "cpu").run()
        tp = {**cfg["task_params"], "ba_distributed": False}
        want = Evaluator(EvalConfig(**{**cfg, "task_params": tp}),
                         "cpu").run()
        assert sorted(res) == sorted(want)
        for k in res:
            if k.startswith("ba_"):
                np.testing.assert_array_equal(res[k], want[k])
        return
    with pytest.raises(exc, match=what):
        Evaluator(EvalConfig(**cfg), "cpu").run()


def test_cli_runs_vo_synthetic_config_on_cpu(tmp_path, capsys):
    import yaml
    with open("configs/vo_synthetic.yaml") as f:
        cfg = yaml.safe_load(f)
    assert cfg["model_type"] == "Alike_s2d"
    assert cfg["task_type"] == "visual_odometer"
    assert cfg["task_params"] == {"pipelined": True, "ba_refine": True}
    assert cfg["data_params"] == {"type": "synthetic_splat_sequence",
                                  "num_frames": 8, "image_size": 512,
                                  "seed": 0}
    assert cfg["extractor_params"]["top_k"] == 1000
    cfg["data_params"].update(num_frames=4, image_size=128)
    cfg["extractor_params"]["top_k"] = 150
    cfg["output_dir"] = str(tmp_path / "out")
    path = tmp_path / "vo.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert cli.main(["-c", str(path), "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["num_frames"] == 4
    with open(tmp_path / "out" / "trajectory.txt") as f:
        assert len(f.read().splitlines()) == 5
