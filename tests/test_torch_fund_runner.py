"""The LK-fundamental slice end to end vs the JAX runner (CPU, 128^2).

ALIKE-t from weights_npz/Alike.npz on both sides, the synthetic plane
sequence (numpy, bit-equal on both sides), float images. The start jitter
is random on both sides and the two streams differ, so the runner
comparisons run at distance 0, where the protocol is deterministic; the
jitter itself is compared on shared angles in tests/test_torch_lk.py.

Tolerances: `per_frame_error` 1e-3 relative (plus 1e-5 px absolute: frame
0 pairs with itself and its error is 0 up to float noise), the LK level's
5e-3 px spread averaged over the keypoints and divided by errors of a
fraction of a pixel; `fundamental_num` (a hit count at th = 3 px) equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models import get_model as jax_get_model
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu.ops import lk as jlk
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.tasks.fundamental import \
    fundamental_metrics as jax_metrics
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch import cli
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.ops.lk import LKParams
from keypoint_bench_tpu_torch.pipeline import lk_fundamental_step
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.weights import load_params

S = 128
EP = {"nms_dist": 4, "threshold": 0, "border_dist": 8, "top_k": 120,
      "min_score": 0.0}
OF = {"distance": 0, "win_size": 11, "levels": 2, "interation": 8}


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


def _cfg(out, matcher="optical_flow", pipelined=False, model="Alike",
         task="FundamentalMatrix", frames=4, **of):
    return dict(model_type=model, task_type=task,
                data_params={"type": "synthetic_sequence",
                             "num_frames": frames, "image_size": S,
                             "seed": 0},
                extractor_params=EP,
                matcher_params={"type": matcher,
                                "optical_flow_params": {**OF, **of},
                                "brute_force_params": {"max_distance": 5.0}},
                task_params={"th": 3, "pipelined": pipelined},
                output_dir=str(out))


def _both(cfg):
    ref = JaxEvaluator(JaxEvalConfig(**cfg)).run()
    got = Evaluator(EvalConfig(**cfg), "cpu").run()
    return got, ref


def _assert_close(got, ref):
    np.testing.assert_allclose(got["per_frame_error"],
                               ref["per_frame_error"], rtol=1e-3, atol=1e-5)
    assert got["fundamental_num"] == ref["fundamental_num"] > 20
    np.testing.assert_allclose(got["fundamental_radio"],
                               ref["fundamental_radio"], rtol=1e-6)
    np.testing.assert_allclose(got["fundamental_error"],
                               ref["fundamental_error"], rtol=1e-3)


@pytest.mark.parametrize("pipelined", [False, True])
def test_optical_flow_run_matches_jax_runner(highest, tmp_path, pipelined):
    got, ref = _both(_cfg(tmp_path, "optical_flow", pipelined))
    assert len(got["per_frame_error"]) == 4
    assert max(got["per_frame_error"][1:]) > 1e-3      # real tracking
    _assert_close(got, ref)
    with open(tmp_path / "results.json") as f:
        assert json.load(f)["fundamental_error"] == got["fundamental_error"]


def test_brute_force_pipelined_matches_jax_runner(highest, tmp_path):
    got, ref = _both(_cfg(tmp_path, "brute_force", True, frames=5))
    _assert_close(got, ref)


def test_brute_force_pipelined_sparse_equals_dense(tmp_path):
    """Alike_s2d takes the sparse sampler in the pipelined brute-force
    run (no dense descriptor map); its matches are the dense path's."""
    sparse = Evaluator(EvalConfig(**_cfg(tmp_path, "brute_force", True,
                                         "Alike_s2d")), "cpu").run()
    dense = Evaluator(EvalConfig(**_cfg(tmp_path, "brute_force", True,
                                        "Alike")), "cpu").run()
    np.testing.assert_allclose(sparse["per_frame_error"],
                               dense["per_frame_error"], rtol=1e-4,
                               atol=1e-6)
    assert sparse["fundamental_num"] == dense["fundamental_num"]


def test_per_pair_equals_pipelined(tmp_path):
    """With no randomness the two runs of the port track the same
    keypoints: per-frame errors within float summation order."""
    a = Evaluator(EvalConfig(**_cfg(tmp_path, pipelined=False)), "cpu").run()
    b = Evaluator(EvalConfig(**_cfg(tmp_path, pipelined=True)), "cpu").run()
    np.testing.assert_allclose(a["per_frame_error"], b["per_frame_error"],
                               rtol=1e-4, atol=1e-6)
    assert a["fundamental_num"] == b["fundamental_num"]


def test_optical_flow_cv_run_matches_jax_runner(highest, tmp_path):
    """cv2 tracks on both sides from equal keypoints: the same tracks, so
    the errors differ by float summation order only."""
    got, ref = _both(_cfg(tmp_path, "optical_flow_cv", win_size=15,
                          levels=2))
    np.testing.assert_allclose(got["per_frame_error"],
                               ref["per_frame_error"], rtol=1e-4, atol=1e-5)
    assert got["fundamental_num"] == ref["fundamental_num"] > 20


def test_uint8_frames_are_normalized(tmp_path):
    """uint8 frames give the float frames' result up to their rounding
    (the per-pair JAX path casts them without /255; the port does not
    copy that)."""
    from keypoint_bench_tpu_torch.datasets.registry import register_preloaded
    cfg = _cfg(tmp_path, pipelined=True)
    ds = get_dataset(cfg["data_params"])
    items = []
    for i in range(len(ds)):
        it = dict(ds[i])
        it["image0"] = np.round(it["image0"] * 255).astype(np.uint8)
        items.append(it)
    register_preloaded("fund_uint8", items)
    cfg8 = {**cfg, "data_params": {"type": "preloaded", "name": "fund_uint8"}}
    for pipelined in (True, False):
        cfg8["task_params"] = {"th": 3, "pipelined": pipelined}
        res = Evaluator(EvalConfig(**cfg8), "cpu").run()
        assert res["fundamental_num"] > 20
        assert 1e-3 < res["fundamental_error"] < 3.0


def test_fundamental_ransac_run(tmp_path):
    cfg = _cfg(tmp_path, "brute_force", task="FundamentalMatrixRansac",
               frames=2)
    a = Evaluator(EvalConfig(**cfg), "cpu").run()
    b = Evaluator(EvalConfig(**cfg), "cpu").run()
    assert a == b                                  # the seed fixes RANSAC
    # a frame matched with itself: every match is an inlier
    assert a["fundamental_radio"] > 0.95


def test_lk_fundamental_step_matches_jax_step(highest):
    """bench.py's `bench_lk_fund` step rebuilt from the JAX functions, on
    consecutive frames of the synthetic sequence."""
    ds = get_dataset({"type": "synthetic_sequence", "num_frames": 3,
                      "image_size": S, "seed": 1})
    imgs0 = np.stack([ds[0]["image0"], ds[1]["image0"]])
    imgs1 = np.stack([ds[1]["image0"], ds[2]["image0"]])
    Fs = np.stack([ds[1]["fundamental"], ds[2]["fundamental"]])
    kw = dict(nms_dist=4, border_dist=8, top_k=120)
    lkw = dict(distance=0.0, win_size=11, levels=3, iterations=8)

    jparams = jax_load_params("Alike")
    s0, _ = jax_get_model("Alike")(jparams, jnp.asarray(imgs0))
    k0, v0 = jd.detection_batch(s0[..., 0], jd.DetectParams(**kw))
    keys = jax.random.split(jax.random.key(0), 2)
    tracked, _ = jlk.optical_flow_batch(
        jnp.asarray(imgs0), jnp.asarray(imgs1), k0[:, :, 0:2], k0[:, :, 0:2],
        keys, jlk.LKParams(**lkw))
    scale = jnp.asarray([S - 1.0, S - 1.0])
    ref = jax.vmap(lambda kk, tr, vv, F: jax_metrics(
        kk[:, 0:2] * scale, tr * scale, vv, F))(k0, tracked, v0,
                                                jnp.asarray(Fs))

    params = load_params("Alike")
    model = get_model("Alike")(params)
    out, tk0, tv0, ttr = lk_fundamental_step(
        model, params, imgs0, imgs1, Fs, torch.Generator().manual_seed(0),
        DetectParams(**kw), LKParams(**lkw), device="cpu")
    np.testing.assert_array_equal(tk0[..., :2].numpy(),
                                  np.asarray(k0)[..., :2])
    np.testing.assert_array_equal(tv0.numpy(), np.asarray(v0))
    np.testing.assert_allclose(ttr.numpy(), np.asarray(tracked), atol=1e-4)
    np.testing.assert_allclose(out["fundamental_error"].numpy(),
                               np.asarray(ref["fundamental_error"]),
                               rtol=1e-3)
    np.testing.assert_array_equal(out["fundamental_num"].numpy(),
                                  np.asarray(ref["fundamental_num"]))
    assert float(out["fundamental_error"].min()) > 1e-3
    with pytest.raises(ValueError, match="params are on"):
        lk_fundamental_step(model, {k: v.to("meta") for k, v in
                                    params.items()}, imgs0, imgs1, Fs,
                            torch.Generator(), DetectParams(**kw),
                            LKParams(**lkw), device="cpu")


def test_cli_runs_fund_synthetic_config_on_cpu(tmp_path, capsys):
    import yaml
    with open("configs/fund_synthetic.yaml") as f:
        cfg = yaml.safe_load(f)
    assert cfg["matcher_params"]["optical_flow_params"] == {
        "distance": 10, "win_size": 21, "levels": 3, "interation": 40,
        "gray": False}
    cfg["data_params"].update(num_frames=3, image_size=S)
    cfg["matcher_params"]["optical_flow_params"]["interation"] = 4
    cfg["output_dir"] = str(tmp_path / "out")
    path = tmp_path / "fund.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert cli.main(["-c", str(path), "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert 0.0 <= json.loads(line)["fundamental_radio"] <= 1.0


@pytest.mark.parametrize("change,what", [
    ({"task_params": {"save_images": True}}, "save_images"),
    ({"task_type": "visual_odometer",
      "matcher_params": {"type": "brute_force"},
      "task_params": {"pipelined": True, "ba_refine": True,
                      "ba_distributed": True}}, "visual_odometer"),
    ({"debug_nans": True}, "debug_nans")])
def test_unported_parts_raise(tmp_path, change, what):
    cfg = {**_cfg(tmp_path), **change}
    if what == "save_images":
        # ported since: the per-pair run writes the JAX runner's match and
        # epipolar overlays of its 4 frame pairs (their pixels against the
        # JAX runner's: tests/test_torch_visualization.py)
        Evaluator(EvalConfig(**cfg), "cpu").run()
        assert sorted(p.name for p in tmp_path.glob("*.png")) == sorted(
            f"fund_{k}_{i}.png" for k in ("matches", "epipolar")
            for i in range(4))
        return
    with pytest.raises(NotImplementedError, match=what):
        Evaluator(EvalConfig(**cfg), "cpu").run()


def test_desc_map_flow_sources_raise_and_pipelined_matchers(tmp_path):
    """LETNet tracks on its descriptor maps, ALIKE-t on the frames (the
    LETNet / GoodPoint runs against the JAX runner are in
    tests/test_torch_sweep.py); the pipelined run serves optical_flow
    and brute_force only."""
    ev = Evaluator(EvalConfig(**_cfg(tmp_path)), "cpu")
    imgs, descs = ("img0", "img1"), ("d0", "d1")
    assert ev._flow_sources(*imgs, *descs) == imgs
    ev.cfg.model_type = "LETNet"
    assert ev._flow_sources(*imgs, *descs) == descs
    cfg = _cfg(tmp_path, "optical_flow_cv", True)
    with pytest.raises(ValueError, match="pipelined"):
        Evaluator(EvalConfig(**cfg), "cpu").run()
