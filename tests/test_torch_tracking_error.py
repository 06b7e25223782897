"""The VisualizeTrackingError task in the PyTorch port vs the JAX runner
(CPU, 128^2, 2 synthetic homography pairs, float frames).

Each pair's keypoints are warped into frame 1 by the ground-truth
homography; LK tracks them from frame 0 into frame 1 starting at the
warped points, and the pair's error is the mean pixel distance of the
tracks from the warped points over the covisible keypoints. ALIKE-t
tracks on the frames, LETNet on its 3-channel descriptor maps. At LK
jitter distance 0 the protocol is deterministic, so the per-pair errors
must agree within 1e-4 px (the LK level's float32 spread over a few
iterations, averaged over the keypoints).
"""
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu_torch import cli, runner
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator

S = 128
EP = {"nms_dist": 4, "threshold": 0, "border_dist": 8, "top_k": 120,
      "min_score": 0.0}
OF = {"distance": 0, "win_size": 11, "levels": 2, "interation": 8}


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


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


def _cfg(out, model="Alike"):
    return dict(model_type=model, task_type="VisualizeTrackingError",
                data_params={"type": "synthetic_homography", "num_pairs": 2,
                             "image_size": S},
                extractor_params=EP,
                matcher_params={"type": "optical_flow",
                                "optical_flow_params": OF},
                output_dir=str(out))


@pytest.mark.parametrize("model", ["Alike", "LETNet"])
def test_tracking_error_matches_jax_runner(highest, tmp_path, model):
    cfg = _cfg(tmp_path, model)
    ref = JaxEvaluator(JaxEvalConfig(**cfg)).run()
    got = Evaluator(EvalConfig(**cfg), "cpu").run()
    assert sorted(got) == sorted(ref) == ["per_pair", "track_error"]
    assert len(got["per_pair"]) == 2
    assert all(e > 1e-3 for e in got["per_pair"])     # real tracking
    np.testing.assert_allclose(got["per_pair"], ref["per_pair"], rtol=0,
                               atol=1e-4)
    assert abs(got["track_error"] - ref["track_error"]) <= 1e-4
    with open(tmp_path / "results.json") as f:
        assert json.load(f)["track_error"] == got["track_error"]


def test_pair_without_warp_counts_zero(tmp_path, monkeypatch):
    """A pair without warp01_params counts 0, as in the JAX runner."""
    ds = get_dataset(_cfg(tmp_path)["data_params"])
    items = [ds[0], {k: v for k, v in ds[1].items()
                     if k != "warp01_params"}]
    monkeypatch.setattr(runner, "get_dataset", lambda params: items)
    res = Evaluator(EvalConfig(**_cfg(tmp_path)), "cpu").run()
    assert res["per_pair"][1] == 0.0 and res["per_pair"][0] > 0.0
    assert res["track_error"] == pytest.approx(res["per_pair"][0] / 2)


def test_uint8_frames_are_normalized(tmp_path, monkeypatch):
    """uint8 frames are scaled to [0, 1], as on every path of the port:
    the result of the float frames u8 / 255."""
    ds = get_dataset(_cfg(tmp_path)["data_params"])
    u8 = [{**ds[i], **{k: np.round(ds[i][k] * 255).astype(np.uint8)
                       for k in ("image0", "image1")}} for i in range(2)]
    f32 = [{**b, **{k: b[k].astype(np.float32) / np.float32(255)
                    for k in ("image0", "image1")}} for b in u8]
    runs = []
    for items in (u8, f32):
        monkeypatch.setattr(runner, "get_dataset", lambda params: items)
        runs.append(Evaluator(EvalConfig(**_cfg(tmp_path)), "cpu").run())
    assert runs[0] == runs[1]


def test_cli_runs_tracking_error_on_cpu(tmp_path, capsys):
    path = tmp_path / "track.yaml"
    path.write_text(yaml.safe_dump(_cfg(tmp_path / "out")))
    assert cli.main(["-c", str(path), "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["track_error"] > 0.0
