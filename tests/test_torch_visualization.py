"""The drawing helpers (utils/visualization.py) and the runner's
`task_params.save_images` / `save_metric_plot` in the PyTorch port against
the JAX package's, on the CPU.

Each plot function gets the same numpy inputs on both sides and must give
the same pixels (cv2 and matplotlib draw on the host in both packages).
The runners run ALIKE-t with brute force on 2 synthetic pairs (frames) at
128^2 for repeatability, MHA, AUC and the per-pair FundamentalMatrix with
save_images: the same PNG names, pixel-equal (the port's keypoints and
matches equal the JAX runner's there; the parity tests of each task hold
them). One JAX Evaluator and one port Evaluator serve the four tasks,
their configs swapped between runs, so ALIKE-t compiles once.
"""
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest

from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.runner import EvalConfig as JaxEvalConfig
from keypoint_bench_tpu.runner import Evaluator as JaxEvaluator
from keypoint_bench_tpu.utils import visualization as jv
from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
from keypoint_bench_tpu_torch.utils import visualization as tv

cv2 = pytest.importorskip("cv2")

S = 128
TASKS = {
    "repeatability": {"type": "synthetic_homography", "num_pairs": 2,
                      "image_size": S},
    "MHA": {"type": "synthetic_homography", "num_pairs": 2, "image_size": S},
    "AUC": {"type": "synthetic_se3", "num_pairs": 2, "image_size": S},
    "FundamentalMatrix": {"type": "synthetic_sequence", "num_frames": 2,
                          "image_size": S, "seed": 0},
}
# the PNGs each task writes for its 2 pairs, under the JAX runner's names
FILES = {
    "repeatability": [f"{i}_repeatability_{s}.png" for i in (0, 1)
                      for s in (0, 1)],
    "MHA": ["mha_matches_0.png", "mha_matches_1.png"],
    "AUC": ["auc_matches_0.png", "auc_matches_1.png"],
    "FundamentalMatrix": [f"fund_{k}_{i}.png" for i in (0, 1)
                          for k in ("matches", "epipolar")],
}


def _scene(seed=0, n=40, h=48, w=64):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    kpts = rng.random((n, 3)).astype(np.float32)
    return rng, img, kpts


def test_plot_kps_error_equals_jax():
    rng, img, kpts = _scene()
    valid = rng.random(40) > 0.2
    errors = rng.random(40) * 5
    errors[3] = np.nan
    for args in ((img, kpts), (img, kpts, valid, errors),
                 (img[None], kpts, valid, None, 2.0, 3, (0, 255, 0))):
        np.testing.assert_array_equal(tv.plot_kps_error(*args),
                                      jv.plot_kps_error(*args))


def test_plot_matches_equals_jax():
    rng, img, _ = _scene()
    img1 = rng.random((40, 56, 1)).astype(np.float32)
    p0 = rng.random((25, 2)) * [63, 47]
    p1 = rng.random((25, 2)) * [55, 39]
    got = tv.plot_matches(img, img1, p0, p1)
    assert got.shape == (48, 64 + 56, 3)
    np.testing.assert_array_equal(got, jv.plot_matches(img, img1, p0, p1))


def test_plot_epipolar_lines_equals_jax():
    rng, img, _ = _scene()
    F = rng.normal(size=(3, 3))
    F0 = F.copy()
    F0[1, :] = 0.0                      # every line has l[1] == 0: skipped
    p0 = rng.random((40, 2)) * [63, 47]
    p1 = rng.random((40, 2)) * [63, 47]
    for f, n in ((F, 30), (F, 5), (F0, 30)):
        np.testing.assert_array_equal(
            tv.plot_epipolar_lines(img, p0, p1, f, n),
            jv.plot_epipolar_lines(img, p0, p1, f, n))


def test_plot_series_and_write_txt_equal_jax(tmp_path):
    pytest.importorskip("matplotlib")
    values = np.random.default_rng(1).random(12)
    tv.plot_series(values, str(tmp_path / "port.png"))
    jv.plot_series(values, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png")),
                                  cv2.imread(str(tmp_path / "jax.png")))
    with open(tmp_path / "port.txt") as a, open(tmp_path / "jax.txt") as b:
        assert a.read() == b.read()


def test_plot_trajectory_3d_equals_jax(tmp_path):
    pytest.importorskip("matplotlib")
    t = np.cumsum(np.random.default_rng(2).normal(size=(9, 3)), axis=0)
    tv.plot_trajectory_3d(t, str(tmp_path / "port.png"))
    jv.plot_trajectory_3d(t, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png")),
                                  cv2.imread(str(tmp_path / "jax.png")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners over the four tasks with save_images, and a
    save_metric_plot of each's per-pair repeatability: {task: (port dir,
    JAX dir, port result, JAX result)}."""
    root = tmp_path_factory.mktemp("save_images")
    base = dict(model_type="Alike", task_type="repeatability",
                data_params=TASKS["repeatability"],
                extractor_params={"nms_dist": 4, "threshold": 0,
                                  "border_dist": 8, "top_k": 100,
                                  "min_score": 0.0},
                matcher_params={"type": "brute_force",
                                "brute_force_params": {"max_distance": 5.0}},
                task_params={"save_images": True},
                output_dir=str(root / "init"))
    set_conv_precision(jax.lax.Precision.HIGHEST)
    try:
        jev = JaxEvaluator(JaxEvalConfig(**base))
        tev = Evaluator(EvalConfig(**base), "cpu")
        out = {}
        for task, dp in TASKS.items():
            dirs = (str(root / task / "port"), str(root / task / "jax"))
            res = []
            for ev, d in zip((tev, jev), dirs):
                ev.cfg = dataclasses.replace(ev.cfg, task_type=task,
                                             data_params=dp, output_dir=d)
                res.append(ev.run())
            out[task] = (*dirs, *res)
        p_dir, j_dir, p_res, j_res = out["repeatability"]
        for ev, d, r in ((tev, p_dir, p_res), (jev, j_dir, j_res)):
            ev.cfg = dataclasses.replace(ev.cfg, output_dir=d)
            ev.save_metric_plot(r["per_pair_repeatability"], "repeatability")
    finally:
        set_conv_precision(None)
    return out


@pytest.mark.parametrize("task", sorted(TASKS))
def test_save_images_equal_jax_runner(runs, task):
    port_dir, jax_dir, _, _ = runs[task]
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(port_dir, "*.png")))
    want = sorted(FILES[task] + (["repeatability.png"]
                                 if task == "repeatability" else []))
    assert names == want
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(jax_dir, "*.png")))
    for name in names:
        got = cv2.imread(os.path.join(port_dir, name))
        ref = cv2.imread(os.path.join(jax_dir, name))
        assert got is not None and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_save_metric_plot_txt_equal_jax_runner(runs):
    port_dir, jax_dir, got, ref = runs["repeatability"]
    with open(os.path.join(port_dir, "repeatability.txt")) as a:
        vals = [float(x) for x in a.read().split()]
    np.testing.assert_allclose(vals, got["per_pair_repeatability"])
    np.testing.assert_allclose(vals, ref["per_pair_repeatability"],
                               atol=1e-6)
