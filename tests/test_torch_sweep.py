"""The detector family end to end in the PyTorch port vs the JAX package
(CPU, 128^2): `pipeline.dense_extract_match` against bench.py's dense
`pair_step` composition, the port's `run_sweep` against the JAX
`run_sweep`, and the runner with Harris `model_params`, KeyNet's missing
descriptors and the LETNet / GoodPoint LK flow sources.

Both sides detect on equal score maps up to float summation order, so
keypoint positions and validity are compared exactly and scores within
1e-5 relative or 1e-4 absolute (DISK's instance norms, as in
tests/test_torch_models.py). Mutual-NN matches of 3-d sigmoid
descriptors (LETNet, GoodPoint) can tie; the parted rows are counted and
must be none here.
sfd2's randomized golden weights overflow its exp-normalized head to NaN
on about half of the pixels, so it detects no valid keypoint on either
side; where NaNs enter the top-k the two orders differ (JAX's lax.sort
orders NaN by its sign bit), so only its valid rows are compared.
Repeatability is a ratio of equal counts: equal within 1e-7.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from keypoint_bench_tpu.models import get_model as jax_get_model
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.ops.detect import DetectParams as JaxDetectParams
from keypoint_bench_tpu.ops.detect import detection
from keypoint_bench_tpu.ops.matching import brute_force_match
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.sweep import run_sweep as jax_run_sweep
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch import sweep
from keypoint_bench_tpu_torch.datasets.synthetic import _texture
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.pipeline import (dense_detect,
                                               dense_extract_match)
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.sweep import run_sweep
from keypoint_bench_tpu_torch.weights import (params_from_jax,
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


S = 128
DP = dict(nms_dist=6, border_dist=8, top_k=300)
GOLDEN = ("DISK", "sfd2", "D2Net")
DESC_MODELS = ("EdgePoint", "GoodPoint", "LETNet", "r2d2", "DISK", "sfd2",
               "D2Net")
SWEEP_MODELS = ("Alike", "EdgePoint", "GoodPoint", "LETNet", "KeyNet",
                "r2d2", "Harris", "DISK", "sfd2", "D2Net", "ORB", "SIFT")


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return stage_golden_weights(str(tmp_path_factory.mktemp("w")))


def _np_params(name):
    if name in GOLDEN:
        return golden_npz(name)
    return {k: np.asarray(v) for k, v in jax_load_params(name).items()}


def _pairs(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return (np.stack([_texture(S, S, rng) for _ in range(n)]),
            np.stack([_texture(S, S, rng) for _ in range(n)]))


def _jax_pair_step(name, p):
    """bench.py:626-640's `pair_step`, vmapped over the pairs."""
    fn, dp = jax_get_model(name), JaxDetectParams(**DP)

    def pair_step(img0, img1):
        s0, d0 = fn(p, img0[None])
        s1, d1 = fn(p, img1[None])
        k0, v0 = detection(s0[0], dp)
        k1, v1 = detection(s1[0], dp)
        _, m1, ok = brute_force_match(k0, v0, k1, v1, d0[0], d1[0], 5.0)
        return jnp.sum(ok), k0, m1
    return jax.jit(jax.vmap(pair_step))


@pytest.mark.parametrize("name", DESC_MODELS)
def test_dense_extract_match_matches_jax_pair_step(highest, name):
    imgs0, imgs1 = _pairs()
    p = _np_params(name)
    n_ref, k0_ref, m1_ref = (np.asarray(x) for x in _jax_pair_step(
        name, {k: jnp.asarray(v) for k, v in p.items()})(
            jnp.asarray(imgs0), jnp.asarray(imgs1)))
    model = get_model(name)(params_from_jax(p))
    n, k0, m1 = (x.numpy() for x in dense_extract_match(
        model, imgs0, imgs1, DetectParams(**DP), device="cpu"))
    valid = k0_ref[..., 2] > 0
    np.testing.assert_array_equal(k0[..., 2] > 0, valid)
    rows = valid if name == "sfd2" else np.ones_like(valid)
    np.testing.assert_array_equal(k0[rows][:, :2], k0_ref[rows][:, :2])
    np.testing.assert_allclose(k0[valid][:, 2], k0_ref[valid][:, 2],
                               rtol=1e-5, atol=1e-4)
    parted = int((~np.all(m1[..., :2] == m1_ref[..., :2], -1) & valid).sum())
    assert parted == 0, f"{parted} matched rows parted of {valid.sum()}"
    assert int(n) == int(n_ref.sum())
    assert name == "sfd2" or int(n) > 20


def test_dense_detect_detector_only_and_checks():
    imgs0, imgs1 = _pairs(1)
    model = get_model("KeyNet")(params_from_jax(_np_params("KeyNet")))
    k, v, desc = dense_detect(model, imgs0, DetectParams(**DP), device="cpu")
    assert desc is None and k.shape == (1, 300, 3) and bool(v.any())
    s_ref, _ = jax_get_model("KeyNet")(
        {k_: jnp.asarray(v_) for k_, v_ in _np_params("KeyNet").items()},
        jnp.asarray(imgs0))
    k_ref, v_ref = detection(s_ref[0], JaxDetectParams(**DP))
    np.testing.assert_array_equal(k[0, :, :2].numpy(),
                                  np.asarray(k_ref)[:, :2])
    np.testing.assert_array_equal(v[0].numpy(), np.asarray(v_ref))
    with pytest.raises(ValueError, match="KeyNet is a detector"):
        dense_extract_match(model, imgs0, imgs1, DetectParams(**DP),
                            device="cpu")
    with pytest.raises(ValueError, match="multiples of 32"):
        dense_detect(model, imgs0[:, :100], DetectParams(**DP), device="cpu")


def _sweep_base(out, weights_dir=None):
    return dict(model_type="Alike", task_type="repeatability",
                data_params={"type": "synthetic_homography", "num_pairs": 2,
                             "image_size": S},
                extractor_params={"nms_dist": 6, "threshold": 0,
                                  "border_dist": 8, "top_k": 200,
                                  "min_score": 0.0},
                task_params={"th": 3}, weights_dir=weights_dir,
                output_dir=str(out))


@pytest.mark.parametrize("name", SWEEP_MODELS)
def test_run_sweep_matches_jax_sweep(highest, weights, tmp_path, name):
    """The sweep of configs/sweep_repeatability.yaml's models (and DISK,
    sfd2, D2Net from staged golden weights, ORB, SIFT) at 128^2, 2
    pairs."""
    wd = weights if name in GOLDEN else None
    got = run_sweep(_sweep_base(tmp_path / "port", wd), [name],
                    device="cpu")[name]
    ref = jax_run_sweep(_sweep_base(tmp_path / "jax", wd), [name])[name]
    assert got["num_feat"] == ref["num_feat"]
    np.testing.assert_allclose(got["repeatability"], ref["repeatability"],
                               atol=1e-7)
    np.testing.assert_allclose(got["rep_mean_err"], ref["rep_mean_err"],
                               rtol=1e-5)
    assert name == "sfd2" or got["repeatability"] > 0.2


def test_sweep_cli_on_cpu_and_missing_weights(tmp_path, capsys):
    spec = {"base": _sweep_base(tmp_path / "cli"),
            "models": ["LETNet", "Harris", "DISK"]}
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(spec))
    assert sweep.main(["-c", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    res = json.loads(out[out.index("{"):])
    assert 0.0 < res["LETNet"]["repeatability"] <= 1.0
    assert 0.0 < res["Harris"]["repeatability"] <= 1.0
    assert "DISK.npz" in res["DISK"]["error"]     # no weights_dir given
    with open("configs/sweep_repeatability.yaml") as f:
        assert yaml.safe_load(f)["models"] == [
            "Alike", "EdgePoint", "GoodPoint", "LETNet", "KeyNet", "r2d2",
            "Harris"]


def _seq_cfg(out, model, matcher="optical_flow", pipelined=False,
             task="FundamentalMatrix", **extra):
    return dict(model_type=model, task_type=task,
                data_params={"type": "synthetic_sequence", "num_frames": 4,
                             "image_size": S, "seed": 0},
                extractor_params={"nms_dist": 4, "threshold": 0,
                                  "border_dist": 8, "top_k": 120,
                                  "min_score": 0.0},
                matcher_params={"type": matcher, "optical_flow_params": {
                    "distance": 0, "win_size": 11, "levels": 2,
                    "interation": 8}},
                task_params={"th": 3, "pipelined": pipelined},
                output_dir=str(out), **extra)


def _both(cfg):
    ref = JaxEvaluator(JaxEvalConfig(**cfg)).run()
    got = Evaluator(EvalConfig(**cfg), "cpu").run()
    return got, ref


@pytest.mark.parametrize("model,pipelined", [
    ("LETNet", False), ("LETNet", True), ("GoodPoint", False),
    ("GoodPoint", True), ("Harris", False)])
def test_lk_flow_sources_match_jax_runner(highest, tmp_path, model,
                                          pipelined):
    """LETNet / GoodPoint track on their 3-channel descriptor maps (the
    reference's matcher-input switch), Harris on the frames: per pair and
    pipelined at LK distance 0, where the protocol is deterministic. The
    tolerances of tests/test_torch_fund_runner.py."""
    cfg = _seq_cfg(tmp_path, model, pipelined=pipelined,
                   model_params={"block_size": 3, "k": 0.05})
    got, ref = _both(cfg)
    np.testing.assert_allclose(got["per_frame_error"],
                               ref["per_frame_error"], rtol=1e-3, atol=1e-5)
    assert got["fundamental_num"] == ref["fundamental_num"] > 20
    assert max(got["per_frame_error"][1:]) > 1e-3


def test_desc_map_flow_sources_track_the_descriptor_maps(tmp_path):
    """The tracker's inputs: LETNet's descriptor maps, not the frames."""
    ev = Evaluator(EvalConfig(**_seq_cfg(tmp_path, "LETNet")), "cpu")
    img = torch.zeros(S, S, 3)
    s, d, _, _ = ev.detect(torch.rand(S, S, 3))
    src0, src1 = ev._flow_sources(img, img, d, d)
    assert src0 is d and src1 is d and d.shape == (S, S, 3)
    ev = Evaluator(EvalConfig(**_seq_cfg(tmp_path, "LETNet_s2d")), "cpu")
    assert ev._flow_sources(img, img, d, d)[0] is img   # as JAX's runner


def test_harris_model_params_match_jax(highest, tmp_path):
    base = _sweep_base(tmp_path)
    base["model_type"] = "Harris"
    runs = {}
    for mp in ({}, {"block_size": 3, "ksize": 3, "k": 0.06}):
        cfg = dict(base, model_params=mp)
        got, ref = _both(cfg)
        assert got["num_feat"] == ref["num_feat"]
        np.testing.assert_allclose(got["repeatability"],
                                   ref["repeatability"], atol=1e-7)
        runs[len(mp)] = got["per_pair_repeatability"]
    assert runs[0] != runs[3]


@pytest.mark.parametrize("model", ["KeyNet", "Harris"])
@pytest.mark.parametrize("task", ["MHA", "AUC", "fund_bf", "fund_bf_pipe",
                                  "vo_pipe", "mha_flow"])
def test_detector_only_models_raise_where_jax_fails(tmp_path, model, task):
    """A step that matches descriptors raises ValueError naming the model;
    the JAX runner fails on the same configs (it samples a None map; run
    for KeyNet, Harris takes the same path)."""
    pairs = {"type": "synthetic_homography", "num_pairs": 1,
             "image_size": S}
    pair_cfg = dict(_sweep_base(tmp_path), data_params=pairs, task_params={})
    cfg = {"MHA": dict(pair_cfg, task_type="MHA"),
           "AUC": dict(pair_cfg, task_type="AUC",
                       data_params={**pairs, "type": "synthetic_se3"}),
           "fund_bf": _seq_cfg(tmp_path, model, "brute_force"),
           "fund_bf_pipe": _seq_cfg(tmp_path, model, "brute_force", True),
           "vo_pipe": _seq_cfg(tmp_path, model, "brute_force", True,
                               "visual_odometer"),
           "mha_flow": dict(pair_cfg, task_type="MHA",
                            matcher_params={"type": "optical_flow"})
           }[task]
    cfg["model_type"] = model
    if task == "vo_pipe":
        # the JAX runner reads the sequence's intrinsics first
        cfg["data_params"] = {**cfg["data_params"], "num_frames": 3}
    if model == "KeyNet":
        with pytest.raises((AttributeError, TypeError)):  # None map indexed
            JaxEvaluator(JaxEvalConfig(**cfg)).run()
    with pytest.raises(ValueError, match=model):
        Evaluator(EvalConfig(**cfg), "cpu").run()


def test_keynet_repeatability_and_flow_run(highest, tmp_path):
    """KeyNet's None descriptors pass through detect; repeatability and
    FundamentalMatrix + optical_flow (on the frames) run as in JAX."""
    ev = Evaluator(EvalConfig(**_seq_cfg(tmp_path, "KeyNet")), "cpu")
    s, d, k, v = ev.detect(np.random.default_rng(0).random((S, S, 3),
                                                            np.float32))
    assert d is None and s.shape == (S, S, 1) and bool(v.any())
    got, ref = _both(_seq_cfg(tmp_path, "KeyNet", pipelined=True))
    np.testing.assert_allclose(got["per_frame_error"],
                               ref["per_frame_error"], rtol=1e-3, atol=1e-5)
    assert got["fundamental_num"] == ref["fundamental_num"]


def test_disk_light_glue_waits_for_its_weights(weights, tmp_path):
    """`lightglue_disk` is not in the repository: both runners raise, and
    under allow_fallback both run brute force tagged matcher_fallback."""
    cfg = dict(_sweep_base(tmp_path, weights), model_type="DISK",
               task_type="MHA", task_params={},
               data_params={"type": "synthetic_homography", "num_pairs": 1,
                            "image_size": S},
               matcher_params={"type": "light_glue"})
    for evaluator in (lambda c: JaxEvaluator(JaxEvalConfig(**c)),
                      lambda c: Evaluator(EvalConfig(**c), "cpu")):
        with pytest.raises(RuntimeError, match="lightglue_disk"):
            evaluator(cfg)
    cfg["matcher_params"] = {"type": "light_glue", "light_glue_params": {
        "allow_fallback": True}}
    with pytest.warns(UserWarning, match="falling back to brute_force"):
        got = Evaluator(EvalConfig(**cfg), "cpu").run()
    with pytest.warns(UserWarning, match="falling back to brute_force"):
        ref = JaxEvaluator(JaxEvalConfig(**cfg))
    assert got["matcher_fallback"] == ref.matcher_fallback == "brute_force"
    assert ref.lightglue_params is None and sorted(
        k for k in got if k.startswith("MHA@")) == ["MHA@3", "MHA@5",
                                                    "MHA@7"]
