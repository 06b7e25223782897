"""Relative-pose traffic: rendered pairs through the port's
`parallel.evaluate.batched_auc_step` (one card, no mesh).

The step returns per pair the pose error (degrees; 180 where the pose
failed) and the inliers recoverPose kept (0 there), from essential
RANSAC over the mutual-NN matches of all keypoints with the pair's seeded
samples.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.geometry import pose_auc
from port_bench.steps.repeatability import _gap, _rel_gap

OUTPUTS = ("pose_error", "inliers")
STEP_MODULE = "keypoint_bench_tpu_torch.parallel.evaluate"


def batch(pool: dict, rows: np.ndarray, seeds: list, traffic: dict) -> dict:
    return {"imgs0": torch.from_numpy(pool["image0"][rows]),
            "imgs1": torch.from_numpy(pool["image1"][rows]),
            "K0": torch.from_numpy(pool["K0"][rows]),
            "K1": torch.from_numpy(pool["K1"][rows]),
            "pose01": torch.from_numpy(pool["pose01"][rows]), "seeds": seeds}


def port_step(model, detect_params, config: dict, traffic: dict,
              match_dtype=None):
    from keypoint_bench_tpu_torch.parallel.evaluate import batched_auc_step

    def step(b):
        err, inl = batched_auc_step(
            model, detect_params, b["imgs0"], b["imgs1"], b["K0"], b["K1"],
            b["pose01"], b["seeds"], solver=traffic["solver"],
            n_hyp=int(traffic["ransac_hypotheses"]),
            bf_max_distance=float(config["matcher"]["max_distance"]),
            sparse=bool(config["sparse_desc"]), match_dtype=match_dtype,
            device=b["imgs0"].device)
        return {"pose_error": err, "inliers": inl}
    return step


def per_pair_gaps(out: np.ndarray, ref: np.ndarray) -> dict:
    return {"pose_error_gap": _gap(out[0], ref[0]),
            "inliers_rel_gap": _rel_gap(out[1], ref[1])}


def aggregate_gaps(outs: np.ndarray, refs: np.ndarray) -> dict:
    """The gap of AUC@5/10/20 over every compared answer, the worst."""
    return {"auc_gap": max(abs(a - b) for a, b in zip(pose_auc(outs[0]),
                                                      pose_auc(refs[0])))}
