"""The port's slice end to end vs the JAX reference (CPU, 128^2).

extract_match (features -> detection -> y-ordered sparse descriptors ->
mutual-NN match) against the JAX pipeline bench.py runs, on the same numpy
images and weights; and the repeatability runner against the JAX runner
on a 2-pair synthetic config. Keypoint coordinates and match counts must
be equal; scores differ by float summation order only (atol 1e-5);
repeatability must be equal and the mean error within rtol 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models.alike_s2d import (alike_s2d_feats_cm,
                                                 transform_params_s2d)
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu.ops import matching as jm
from keypoint_bench_tpu.ops import sparse_desc as jsd
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch import cli
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.pipeline import extract_match
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.weights import load_params

S = 128


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


def _pairs(n):
    ds = get_dataset({"type": "synthetic_homography", "num_pairs": n,
                      "image_size": S})
    return (np.stack([ds[i]["image0"] for i in range(n)]),
            np.stack([ds[i]["image1"] for i in range(n)]))


def _jax_extract_match(imgs0, imgs1, kw):
    params = transform_params_s2d(jax_load_params("Alike"))
    dp = jd.DetectParams(**kw)

    def ext(imgs):
        s, f = alike_s2d_feats_cm(params, jnp.asarray(imgs))
        k, v = jd.detection_batch(s[..., 0], dp)
        return jsd.alike_sparse_descriptors_cm_batch_yorder(
            params, tuple(f), k, v, S, S, interpret=True)

    d0, k0, v0 = ext(imgs0)
    d1, k1, v1 = ext(imgs1)
    nn01, ok = jax.vmap(lambda a, b, va, vb: jm.mutual_nn_match(
        a, b, va, vb, 5.0))(d0, d1, v0, v1)
    return int(jnp.sum(ok)), np.asarray(k0), np.asarray(
        jax.vmap(jm.take_rows)(k1, nn01))


def test_extract_match_matches_jax(highest):
    imgs0, imgs1 = _pairs(2)
    kw = dict(nms_dist=6, border_dist=8, top_k=200)
    n_ref, k0_ref, m1_ref = _jax_extract_match(imgs0, imgs1, kw)
    params = load_params("Alike")
    model = get_model("Alike")(params)
    n, k0, m1 = extract_match(model, params, imgs0, imgs1,
                              DetectParams(**kw), 5.0, device="cpu")
    assert int(n) == n_ref > 50
    np.testing.assert_array_equal(k0[..., :2].numpy(), k0_ref[..., :2])
    np.testing.assert_allclose(k0[..., 2].numpy(), k0_ref[..., 2], atol=1e-5)
    np.testing.assert_array_equal(m1[..., :2].numpy(), m1_ref[..., :2])


def _config(tmp_path, name):
    return {"model_type": "Alike", "task_type": "repeatability",
            "data_params": {"type": "synthetic_homography", "num_pairs": 2,
                            "image_size": S},
            "extractor_params": {"nms_dist": 6, "threshold": 0,
                                 "border_dist": 8, "top_k": 1000,
                                 "min_score": 0.0},
            "task_params": {"th": 3},
            "output_dir": str(tmp_path / name)}


def test_repeatability_runner_matches_jax(tmp_path, highest):
    ref = JaxEvaluator(JaxEvalConfig.from_dict(_config(tmp_path, "jax"))
                       ).run()
    got = Evaluator(EvalConfig.from_dict(_config(tmp_path, "torch")),
                    device="cpu").run()
    assert got["per_pair_repeatability"] == ref["per_pair_repeatability"]
    assert got["repeatability"] == ref["repeatability"] > 0.1
    assert got["num_feat"] == ref["num_feat"]
    np.testing.assert_allclose(got["rep_mean_err"], ref["rep_mean_err"],
                               rtol=1e-5)
    with open(tmp_path / "torch" / "results.json") as f:
        assert json.load(f)["repeatability"] == got["repeatability"]


def test_cli_writes_results(tmp_path, capsys):
    import yaml
    cfg = _config(tmp_path, "cli")
    cfg["data_params"]["num_pairs"] = 1
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert cli.main(["-c", str(path), "test", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("repeatability ")
    last = json.loads(lines[-1])
    with open(tmp_path / "cli" / "results.json") as f:
        assert json.load(f)["repeatability"] == last["repeatability"]


def test_runner_normalizes_uint8(tmp_path):
    ev = Evaluator(EvalConfig.from_dict(_config(tmp_path, "u8")),
                   device="cpu")
    img8 = (np.random.default_rng(1).random((64, 64, 3)) * 255).astype(
        np.uint8)
    k8, v8 = ev.detect(img8)[2:]
    kf, vf = ev.detect(img8.astype(np.float32) / 255.0)[2:]
    np.testing.assert_array_equal(k8.numpy(), kf.numpy())
    np.testing.assert_array_equal(v8.numpy(), vf.numpy())


@pytest.mark.parametrize("field,value,extra", [
    # the five-point solver this case raised for is ported
    # (tests/test_torch_fivepoint.py), and so are the plots
    pytest.param("task_params", {"save_images": True}, {},
                 id="task_params-save_images")])
def test_unported_options_raise(tmp_path, field, value, extra):
    cfg = {**_config(tmp_path, "x"), field: value, **extra}
    if value == {"save_images": True}:
        # the run writes the JAX runner's keypoint overlays of both sides
        # of its 2 pairs (their pixels against the JAX runner's:
        # tests/test_torch_visualization.py)
        Evaluator(EvalConfig.from_dict(cfg), device="cpu").run()
        assert sorted(p.name for p in (tmp_path / "x").glob("*.png")) == [
            f"{i}_repeatability_{s}.png" for i in (0, 1) for s in (0, 1)]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Evaluator(EvalConfig.from_dict(cfg), device="cpu").run()


def test_extract_match_accepts_uint8(highest):
    imgs0, imgs1 = _pairs(1)
    params = load_params("Alike")
    model = get_model("Alike")(params)
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=100)
    to8 = [(np.clip(x, 0, 1) * 255).round().astype(np.uint8)
           for x in (imgs0, imgs1)]
    n8 = extract_match(model, params, *to8, dp, device="cpu")[0]
    nf = extract_match(model, params,
                       *(torch.from_numpy(x.astype(np.float32) / 255.0)
                         for x in to8), dp, device="cpu")[0]
    assert int(n8) == int(nf) > 0


def test_extract_match_refuses_weights_on_another_device():
    """The step moves no weights: params elsewhere than `device` raise."""
    params = {k: v.to("meta") for k, v in load_params("Alike").items()}
    imgs = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(ValueError, match="params are on meta"):
        extract_match(get_model("Alike")(params), params, imgs, imgs,
                      DetectParams(), device="cpu")
