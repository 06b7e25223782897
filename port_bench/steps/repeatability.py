"""Repeatability traffic: homography pairs through the port's
`parallel.evaluate.batched_repeatability_step` (one card, no mesh).

The step returns per pair: repeatability, mean_error (px), num_feat,
gt_num and homography_inliers (RANSAC-H over the mutual-NN matches of the
covisible keypoints, from the pair's seeded samples).
"""
from __future__ import annotations

import numpy as np
import torch

OUTPUTS = ("repeatability", "mean_error", "num_feat", "gt_num",
           "homography_inliers")
STEP_MODULE = "keypoint_bench_tpu_torch.parallel.evaluate"


def batch(pool: dict, rows: np.ndarray, seeds: list, traffic: dict) -> dict:
    """Host batch of pool rows: tensors (pinned by the caller), the
    host-side sizes and the RANSAC seeds."""
    s = float(traffic["image_size"])
    return {"imgs0": torch.from_numpy(pool["image0"][rows]),
            "imgs1": torch.from_numpy(pool["image1"][rows]),
            "H": torch.from_numpy(pool["H"][rows]),
            "Hinv": torch.from_numpy(pool["Hinv"][rows]),
            "scale": torch.full((len(rows),), s),
            "sizes": np.full((len(rows), 2), s), "seeds": seeds}


def port_step(model, detect_params, config: dict, traffic: dict,
              match_dtype=None):
    """b (a batch on the card) -> {output: [B] tensor}."""
    from keypoint_bench_tpu_torch.parallel.evaluate import (
        N_HYP_H, batched_repeatability_step)
    if int(traffic["ransac_hypotheses"]) != N_HYP_H:
        raise ValueError(f"the step draws {N_HYP_H} RANSAC-H hypotheses, "
                         f"the traffic says {traffic['ransac_hypotheses']}")

    def step(b):
        return batched_repeatability_step(
            model, detect_params, b["imgs0"], b["imgs1"], b["H"], b["Hinv"],
            b["sizes"], b["scale"], b["seeds"], th=float(traffic["th"]),
            bf_max_distance=float(config["matcher"]["max_distance"]),
            sparse=bool(config["sparse_desc"]), match_dtype=match_dtype,
            device=b["imgs0"].device)
    return step


def _gap(a, b):
    """|a - b|, 0 where both are NaN (no hit in either), inf where one is."""
    d = np.abs(a - b)
    both = np.isnan(a) & np.isnan(b)
    return np.where(both, 0.0, np.where(np.isnan(d), np.inf, d))


def _rel_gap(a, b):
    """|a - b| / max(b, 1) for counts; inf where b is not finite."""
    with np.errstate(invalid="ignore"):
        return np.where(np.isfinite(b), _gap(a, b) / np.maximum(b, 1.0),
                        np.inf)


def per_pair_gaps(out: np.ndarray, ref: np.ndarray) -> dict:
    """[outputs, B] program and reference rows -> {number: [B] gaps}."""
    o = dict(zip(OUTPUTS, out))
    r = dict(zip(OUTPUTS, ref))
    return {"repeatability_gap": _gap(o["repeatability"],
                                      r["repeatability"]),
            "mean_error_gap": _gap(o["mean_error"], r["mean_error"]),
            "num_feat_gap": _gap(o["num_feat"], r["num_feat"]),
            "gt_num_gap": _gap(o["gt_num"], r["gt_num"]),
            "inliers_rel_gap": _rel_gap(o["homography_inliers"],
                                        r["homography_inliers"])}


def aggregate_gaps(outs: np.ndarray, refs: np.ndarray) -> dict:
    """[outputs, n] of every compared answer -> the gaps of what the
    protocol reports over them: mean repeatability and mean error."""
    o = dict(zip(OUTPUTS, outs))
    r = dict(zip(OUTPUTS, refs))
    return {"mean_repeatability_gap": abs(float(np.mean(o["repeatability"]))
                                          - float(np.mean(
                                              r["repeatability"]))),
            "mean_error_mean_gap": float(_gap(
                np.nanmean(o["mean_error"]), np.nanmean(r["mean_error"])))}
