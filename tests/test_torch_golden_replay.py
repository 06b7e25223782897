"""Golden-number replay of the port: the five BASELINE.json configs against
real data, the counterpart of tests/test_golden_replay.py.

The command to run the day the datasets are mounted (on the card when
one is present, else on the CPU):

    python -m pytest tests/test_torch_golden_replay.py -q

Each test loads its shipped config (configs/*.yaml), checks that the real
dataset root is mounted (KBT_DATA_ROOT replaces the default /data
prefix), SKIPS cleanly when it is absent, and otherwise runs the port's
Evaluator and holds it to the BASELINE.md published values with the
tolerances of tests/test_golden_replay.py:

  1. ALIKE-t repeatability on HPatches-v: rep 0.3157695 +/- 0.02, mean
     err 1.2313193 +/- 0.10; and the batch_size=8 run equal to the
     per-pair run on the same data.
  2. ALIKE MHA@3/5/7 on HPatches: 0.491/0.583/0.657 +/- 0.05.
  3. ALIKE AUC@5/10/20 on MegaDepth: 0.375/0.527/0.661 +/- 0.05.
  4. ALIKE + LK fundamental epipolar error on TartanAir ME000: 9.428 +/-
     1.5.
  5. Full VO on KITTI seq 00: no published baseline; the trajectory
     completes, is finite, and its Umeyama ATE against the ground truth
     beats the identity-rotation drift of the ground-truth step lengths
     by 4x (or stays under 5% of the path on a near-straight sequence).
"""
import os

import numpy as np
import pytest
import torch

from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator

pytestmark = pytest.mark.golden_replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
DATA_ROOT = os.environ.get("KBT_DATA_ROOT", "/data")
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def _load(name: str, tmp_path, **overrides) -> EvalConfig:
    cfg = EvalConfig.from_yaml(os.path.join(CONFIGS, name))
    dp = dict(cfg.data_params)
    for key in ("root", "gt"):
        if key in dp and isinstance(dp[key], str) \
                and dp[key].startswith("/data"):
            dp[key] = dp[key].replace("/data", DATA_ROOT, 1)
    cfg.data_params = dp
    cfg.output_dir = str(tmp_path / "out")
    for k, v in overrides.items():
        if k == "data_params":
            cfg.data_params = {**cfg.data_params, **v}
        else:
            setattr(cfg, k, v)
    root = cfg.data_params.get("root")
    if root and not os.path.exists(root):
        pytest.skip(f"dataset root not mounted: {root}")
    gt = cfg.data_params.get("gt")
    if gt and not os.path.exists(gt):
        pytest.skip(f"dataset GT not mounted: {gt}")
    return cfg


def test_replay_repeatability_hpatches(tmp_path):
    cfg = _load("repeatability_hpatches.yaml", tmp_path)
    res = Evaluator(cfg, DEVICE).run()
    assert res["repeatability"] == pytest.approx(0.3157695, abs=0.02), res
    assert res["rep_mean_err"] == pytest.approx(1.2313193, abs=0.10), res


def test_replay_repeatability_hpatches_sharded_equals_per_pair(tmp_path):
    """The batch_size > 1 path must not change the metric on real data."""
    cfg = _load("repeatability_hpatches.yaml", tmp_path / "pp")
    res_pp = Evaluator(cfg, DEVICE).run()
    cfg_sh = _load("repeatability_hpatches.yaml", tmp_path / "sh",
                   data_params={"batch_size": 8})
    res_sh = Evaluator(cfg_sh, DEVICE).run()
    assert res_sh["repeatability"] == \
        pytest.approx(res_pp["repeatability"], abs=1e-4)
    assert res_sh["rep_mean_err"] == \
        pytest.approx(res_pp["rep_mean_err"], abs=1e-3)


def test_replay_mha_hpatches(tmp_path):
    cfg = _load("mha_hpatches.yaml", tmp_path)
    res = Evaluator(cfg, DEVICE).run()
    assert res["MHA@3"] == pytest.approx(0.491, abs=0.05), res
    assert res["MHA@5"] == pytest.approx(0.583, abs=0.05), res
    assert res["MHA@7"] == pytest.approx(0.657, abs=0.05), res


def test_replay_auc_megadepth(tmp_path):
    cfg = _load("auc_megadepth.yaml", tmp_path)
    res = Evaluator(cfg, DEVICE).run()
    assert res["AUC@5"] == pytest.approx(0.375, abs=0.05), res
    assert res["AUC@10"] == pytest.approx(0.527, abs=0.05), res
    assert res["AUC@20"] == pytest.approx(0.661, abs=0.05), res


def test_replay_fund_tartanair(tmp_path):
    cfg = _load("fund_tartanair.yaml", tmp_path)
    res = Evaluator(cfg, DEVICE).run()
    assert res["fundamental_error"] == pytest.approx(9.428, abs=1.5), res


def test_replay_vo_kitti(tmp_path):
    cfg = _load("vo_kitti.yaml", tmp_path)
    res = Evaluator(cfg, DEVICE).run()
    assert res["num_frames"] > 0
    t_est = np.asarray(res["t_est"])
    assert np.isfinite(t_est).all()
    gt_file = cfg.data_params.get("gt")
    if gt_file and os.path.exists(gt_file):
        from keypoint_bench_tpu_torch.tasks.trajectory import (
            ate_rmse, read_kitti_trajectory)
        gt_R, gt_t = read_kitti_trajectory(gt_file)
        n = min(len(gt_t), len(t_est))
        ate = ate_rmse(t_est[:n], gt_t[:n])
        assert np.isfinite(ate), ate
        # the bound of tests/test_golden_replay.py: the canonical broken
        # solver (identity rotations chained at the ground truth's step
        # lengths) walks a straight line; the estimate must beat its
        # aligned ATE by 4x
        steps = np.linalg.norm(np.diff(gt_t[:n], axis=0), axis=1)
        path_len = float(steps.sum())
        broken = np.zeros((n, 3))
        broken[1:, 2] = np.cumsum(steps)
        ate_broken = ate_rmse(broken, gt_t[:n])
        if ate_broken > 0.05 * path_len:
            assert ate < 0.25 * ate_broken, (ate, ate_broken)
        else:
            # a near-straight ground truth: identity drift cannot be told
            # apart under Umeyama alignment
            assert ate < 0.05 * path_len, (ate, path_len)
