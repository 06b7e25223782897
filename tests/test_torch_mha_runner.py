"""The MHA slice end to end vs the JAX runner (CPU, 128^2, 2 pairs).

SuperPoint and LightGlue from the golden randomized full-width weights,
staged into a weights_dir as both runners load them. For each pair the
port's `_match` outputs (matched keypoints and mask) must equal the JAX
runner's, for the brute-force and the LightGlue matcher. RANSAC draws from
different random streams on the two sides, so the MHA hits are compared
in tests/test_torch_ransac_mha.py on shared samples; here they must be
well-formed. The batched `superpoint_mha_step` must give the runner's
per-pair matches. Also the JAX runner's error semantics for LightGlue
without weights; what the runner's options do on this config
(save_images, ba_distributed, brute force at batch_size 2 on MHA and
AUC, debug_nans); an unknown matcher, which the port refuses where the
JAX runner runs brute force; and LightGlue with data_params.batch_size >
1, which runs the per-pair loop, as in the JAX runner.
"""
import json

import jax
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu_torch import cli
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.pipeline import superpoint_mha_step
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.weights import load_npz, stage_golden_weights


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128
EP = {"nms_dist": 4, "threshold": 0, "border_dist": 8, "top_k": 150,
      "min_score": 0.0}


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return stage_golden_weights(str(tmp_path_factory.mktemp("weights")))


def _cfg(weights_dir, out, matcher="brute_force", lg=None, **kw):
    mp = {"type": matcher, "brute_force_params": {"max_distance": 5.0}}
    if lg is not None:
        mp["light_glue_params"] = lg
    return dict(model_type="SuperPoint", task_type="MHA",
                data_params={"type": "synthetic_homography", "num_pairs": 2,
                             "image_size": S},
                extractor_params=EP, matcher_params=mp,
                weights_dir=weights_dir, output_dir=str(out), **kw)


def _pair_matches(ev, batch, to_np, scores=None):
    """The runner's per-pair matches; with `scores`, LightGlue's mscores of
    the same inputs (lightglue_forward of that package)."""
    img0, img1, s0, d0, k0, v0, s1, d1, k1, v1 = ev._pair_maps(batch)
    _, _, va = ev._warp(k0, v0, batch["warp01_params"])
    _, _, vb = ev._warp(k1, v1, batch["warp10_params"])
    w, h = img0.shape[1], img0.shape[0]
    m0, m1, ok = ev._match(k0, va, k1, vb, d0, d1, w, h)
    out = [to_np(x) for x in (m0, m1, ok)]
    if scores:
        sample, forward = scores
        p0, p1 = k0[:, :2] * (w - 1.0), k1[:, :2] * (w - 1.0)
        out.append(to_np(forward(ev.lightglue_params, p0, va,
                                 sample(p0, d0, 8), p1, vb,
                                 sample(p1, d1, 8))[1]))
    return out


@pytest.mark.parametrize("matcher", ["brute_force", "light_glue",
                                     "adaptive"])
def test_match_outputs_equal_jax_runner(highest, weights, tmp_path, matcher):
    """"adaptive" is light_glue with light_glue_params.adaptive: the
    reference's default mode, with early exit and width pruning."""
    from keypoint_bench_tpu.models import lightglue as jlg
    from keypoint_bench_tpu.models import lightglue_adaptive as jla
    from keypoint_bench_tpu_torch.models import lightglue as tlg
    from keypoint_bench_tpu_torch.models import lightglue_adaptive as tla
    if matcher == "adaptive":
        cfg = _cfg(weights, tmp_path, "light_glue", {"adaptive": True})
    else:
        cfg = _cfg(weights, tmp_path, matcher)
    jev = JaxEvaluator(JaxEvalConfig(**cfg))
    tev = Evaluator(EvalConfig(**cfg), "cpu")
    ds = get_dataset(cfg["data_params"])
    lg = matcher != "brute_force"
    if matcher == "adaptive":
        forwards = (jla.lightglue_forward_adaptive,
                    tla.lightglue_forward_adaptive)
    else:
        forwards = (jlg.lightglue_forward, tlg.lightglue_forward)
    n_ok = 0
    for i in range(len(ds)):
        ref = _pair_matches(jev, ds[i], np.asarray, lg and (
            jlg.sample_descriptors_lg, forwards[0]))
        got = _pair_matches(tev, ds[i], lambda t: t.numpy(), lg and (
            tlg.sample_descriptors_lg, forwards[1]))
        np.testing.assert_array_equal(got[0][:, :2], ref[0][:, :2])
        np.testing.assert_allclose(got[0][:, 2], ref[0][:, 2], atol=1e-5)
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[1][got[2], :2],
                                      ref[1][ref[2], :2])
        if lg:
            # the randomized weights keep every mscore under LightGlue's
            # 0.1 filter, so the scores carry the comparison
            np.testing.assert_allclose(got[3], ref[3], atol=1e-4)
            n_ok += int((got[3] > 0).sum())
        n_ok += int(got[2].sum())
    assert n_ok > 0


@pytest.mark.parametrize("matcher", ["brute_force", "light_glue"])
def test_mha_run_and_batched_step(weights, tmp_path, matcher):
    cfg = _cfg(weights, tmp_path, matcher, task_params={"th": [3, 5, 7]})
    ev = Evaluator(EvalConfig(**cfg), "cpu")
    res = ev.run()
    assert set(res) >= {"MHA@3", "MHA@5", "MHA@7", "per_pair"}
    assert all(0.0 <= res[f"MHA@{t}"] <= 1.0 for t in (3, 5, 7))
    assert len(res["per_pair"]) == 2
    with open(tmp_path / "results.json") as f:
        assert json.load(f)["MHA@5"] == res["MHA@5"]

    ds = get_dataset(cfg["data_params"])
    items = [ds[i] for i in range(2)]
    stack = [np.stack([it[k] for it in items]) for k in ("image0", "image1")]
    Hs = np.stack([it["warp01_params"]["homography_matrix"] for it in items])
    Hinvs = np.stack([it["warp10_params"]["homography_matrix"]
                      for it in items])
    hits, m0, m1, ok = superpoint_mha_step(
        ev.model, *stack, Hs, Hinvs, DetectParams(**{
            k: v for k, v in EP.items() if k != "threshold"}),
        torch.Generator().manual_seed(0), matcher,
        ev.lightglue_params, device="cpu")
    assert hits.shape == (2, 3) and ((hits == 0) | (hits == 1)).all()
    for i in range(2):
        r0, r1, rok = _pair_matches(ev, items[i], lambda t: t)
        assert torch.equal(ok[i], rok) and torch.equal(m0[i], r0)
        assert torch.equal(m1[i][ok[i]], r1[rok])


def test_cli_runs_mha_on_cpu(weights, tmp_path, capsys):
    path = tmp_path / "mha.yaml"
    path.write_text(__import__("yaml").safe_dump(
        _cfg(weights, tmp_path / "out", "light_glue")))
    assert cli.main(["-c", str(path), "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert 0.0 <= json.loads(line)["MHA@3"] <= 1.0


def test_lightglue_without_weights_raises_or_falls_back(tmp_path):
    d = tmp_path / "w"
    d.mkdir()
    staged = stage_golden_weights(str(tmp_path / "all"))
    np.savez(d / "SuperPoint.npz", **load_npz("SuperPoint", staged))
    with pytest.raises(RuntimeError, match="light_glue"):
        Evaluator(EvalConfig(**_cfg(str(d), tmp_path, "light_glue")), "cpu")
    with pytest.warns(UserWarning, match="falling back"):
        ev = Evaluator(EvalConfig(**_cfg(str(d), tmp_path, "light_glue",
                                         {"allow_fallback": True})), "cpu")
    assert ev.lightglue_params is None
    assert ev.run()["matcher_fallback"] == "brute_force"
    cfg = _cfg(str(d), tmp_path, "light_glue")
    cfg["model_type"] = "Harris"
    with pytest.raises(RuntimeError, match="adapter"):
        Evaluator.__new__(Evaluator)._init_matcher(EvalConfig(**cfg))


def test_save_images_writes_the_match_overlays(weights, tmp_path):
    """The run writes the JAX runner's match overlay of each pair (their
    pixels against the JAX runner's: tests/test_torch_visualization.py)."""
    cfg = {**_cfg(weights, tmp_path), "task_params": {"save_images": True}}
    Evaluator(EvalConfig(**cfg), "cpu").run()
    assert sorted(p.name for p in tmp_path.glob("*.png")) == [
        "mha_matches_0.png", "mha_matches_1.png"]


def test_ba_distributed_refines_the_window_on_one_rank(weights, tmp_path):
    """ba_distributed refines the window with the distributed Schur
    solver over the Evaluator's ranks (one here;
    tests/test_torch_parallel_ba.py holds it on 2 and against JAX)."""
    cfg = {**_cfg(weights, tmp_path), "task_type": "visual_odometer",
           "matcher_params": {"type": "brute_force"},
           "task_params": {"pipelined": True, "ba_refine": True,
                           "ba_distributed": True},
           "data_params": {"type": "synthetic_splat_sequence",
                           "num_frames": 3, "image_size": S}}
    res = Evaluator(EvalConfig(**cfg), "cpu").run()
    assert res["num_frames"] == 3 and len(res["R_est"]) == 4


@pytest.mark.parametrize("task,key", [("MHA", "per_pair"),
                                      ("AUC", "per_pair_error")])
def test_brute_force_batch_size_runs_the_batch_path(weights, tmp_path, task,
                                                    key):
    """Brute force at batch_size 2 runs the data-parallel batch path
    (tests/test_torch_parallel_runner.py holds it against the JAX
    runner)."""
    data = "synthetic_homography" if task == "MHA" else "synthetic_se3"
    cfg = {**_cfg(weights, tmp_path), "task_type": task,
           "data_params": {"type": data, "num_pairs": 2, "image_size": S,
                           "batch_size": 2}}
    assert len(Evaluator(EvalConfig(**cfg), "cpu").run()[key]) == 2


def test_debug_nans_run_equals_the_plain_run(weights, tmp_path):
    """debug_nans checks every operation for NaN and leaves the results
    as they are (tests/test_torch_debug_nans.py holds it against the JAX
    runner's jax.debug_nans on every task type)."""
    plain = Evaluator(EvalConfig(**_cfg(weights, tmp_path)), "cpu").run()
    cfg = {**_cfg(weights, tmp_path), "debug_nans": True}
    assert Evaluator(EvalConfig(**cfg), "cpu").run() == plain


def test_unknown_matcher_raises_where_jax_runs_brute_force(weights,
                                                           tmp_path):
    """The JAX runner matches by brute force under any matcher label it
    does not know; the port raises ValueError naming the four it knows."""
    ds = get_dataset(_cfg(weights, tmp_path)["data_params"])
    jax_runs = [_pair_matches(JaxEvaluator(JaxEvalConfig(
        **_cfg(weights, tmp_path, m))), ds[0], np.asarray)
        for m in ("superglue", "brute_force")]
    for a, b in zip(*jax_runs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="brute_force, light_glue, "
                       "optical_flow, optical_flow_cv"):
        Evaluator(EvalConfig(**_cfg(weights, tmp_path, "superglue")), "cpu")


def test_light_glue_batch_size_runs_per_pair_loop(weights, tmp_path):
    """Only brute force has a sharded MHA path: LightGlue at batch_size 2
    runs the per-pair loop and equals the batch_size 1 run."""
    runs = []
    for bs in (1, 2):
        cfg = _cfg(weights, tmp_path / f"bs{bs}", "light_glue",
                   task_params={"th": [3, 5, 7]})
        cfg["data_params"] = {**cfg["data_params"], "batch_size": bs}
        runs.append(Evaluator(EvalConfig(**cfg), "cpu").run())
    assert len(runs[1]["per_pair"]) == 2
    assert runs[1] == runs[0]
