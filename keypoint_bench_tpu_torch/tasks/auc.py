"""Relative-pose AUC (counterpart of keypoint_bench_tpu/tasks/auc.py;
reference tasks/AUC.py:40-155).

Matched pixels are normalized by the intrinsics with the threshold 1 px /
f_mean; essential RANSAC (8-point, or the five-point solver of
geometry/fivepoint.py) and recoverPose give (R, t); the pose error is the
larger of the angular t error (with its 180-degree ambiguity) and the
angular R error; a failed pair counts 180 degrees. `pose_auc` is the
trapezoid AUC of the error-recall curve at {5, 10, 20} degrees, on the
host. Every device function takes leading batch dimensions.
"""
from __future__ import annotations

import numpy as np
import torch

from keypoint_bench_tpu_torch.geometry.fivepoint import \
    ransac_essential_5pt_from_samples
from keypoint_bench_tpu_torch.geometry.ransac import (
    _sample_minimal, ransac_essential_from_samples, recover_pose)
from keypoint_bench_tpu_torch.utils import profiling


def ransac_sample_shape(solver: str, n_hyp: int) -> tuple[int, int]:
    """(samples, points a sample) that essential RANSAC draws: n_hyp
    samples of 8 for "8pt"; max(n_hyp // 8, 64) of 5 for "5pt", whose
    samples give up to 10 candidates each."""
    if solver not in ("8pt", "5pt"):
        raise ValueError(f"unknown solver {solver!r}")
    return (max(n_hyp // 8, 64), 5) if solver == "5pt" else (n_hyp, 8)


def estimate_pose_pair(m_pts0: torch.Tensor, m_pts1: torch.Tensor,
                       match_mask: torch.Tensor, K0: torch.Tensor,
                       K1: torch.Tensor, generator: torch.Generator | None,
                       thresh_px: float = 1.0, n_hyp: int = 4096,
                       solver: str = "8pt",
                       samples: torch.Tensor | None = None):
    """m_pts0/1 [..., K, 2] matched pixel coordinates, match_mask [..., K],
    K0/K1 [..., 3, 3]. Returns (R [..., 3, 3], t [..., 3], inlier mask
    [..., K], n_inliers [...], ok [...]).

    solver "8pt" (8-point minimal samples, projected refit) or "5pt" (the
    five-point minimal solver, geometry/fivepoint.py: up to 10 candidates
    a sample, so max(n_hyp // 8, 64) samples explore at least as many
    hypotheses). The minimal samples [..., n, 8] or [..., n, 5] come from
    `generator` (on the tensors' device), or are given as `samples`."""
    n, size = ransac_sample_shape(solver, n_hyp)

    def normalize(p, K):
        c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)[..., None, :]
        f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)[..., None, :]
        return (p - c) / f

    with profiling.span("kbt.geometry.pose"):
        f_mean = (K0[..., 0, 0] + K1[..., 1, 1] + K0[..., 0, 0]
                  + K1[..., 1, 1]) / 4.0                    # AUC.py:45
        norm_th = thresh_px / f_mean
        p0n, p1n = normalize(m_pts0, K0), normalize(m_pts1, K1)
        ransac = ransac_essential_5pt_from_samples if solver == "5pt" \
            else ransac_essential_from_samples
        if samples is None:
            samples = _sample_minimal(match_mask, n, size, generator)
        E, inl, ok_e = ransac(p0n, p1n, match_mask, samples, norm_th)
        with profiling.span("kbt.geometry.pose.recover"):
            R, t, pose_mask, n_in = recover_pose(E, p0n, p1n, inl)
        return R, t, pose_mask, n_in, ok_e & (match_mask.sum(-1) >= 5)


def pose_error(R_est: torch.Tensor, t_est: torch.Tensor,
               T_0to1: torch.Tensor) -> torch.Tensor:
    """max(angular t error, angular R error) in degrees (reference
    AUC.py:66-84): R_est [..., 3, 3], t_est [..., 3], T_0to1 [..., 4, 4]."""
    R_gt, t_gt = T_0to1[..., :3, :3], T_0to1[..., :3, 3]
    n = torch.linalg.vector_norm(t_est, dim=-1) * torch.linalg.vector_norm(
        t_gt, dim=-1)
    cos_t = ((t_est * t_gt).sum(-1) / n.clamp_min(1e-12)).clamp(-1.0, 1.0)
    err_t = torch.rad2deg(torch.arccos(cos_t))
    err_t = torch.minimum(err_t, 180.0 - err_t)
    tr = torch.diagonal(R_est.transpose(-1, -2) @ R_gt, dim1=-2,
                        dim2=-1).sum(-1)
    cos_r = ((tr - 1) / 2.0).clamp(-1.0, 1.0)
    err_r = torch.rad2deg(torch.arccos(cos_r).abs())
    return torch.maximum(err_t, err_r)


def pose_auc(errors, thresholds=(5.0, 10.0, 20.0)) -> list:
    """Trapezoid AUC of the error-recall curve (reference AUC.py:86-98),
    in numpy on the host, the trapezoid sum written out."""
    errors = np.sort(np.asarray(errors))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.r_[recall[:last], recall[last - 1]]
        e = np.r_[errors[:last], t]
        area = float(((e[1:] - e[:-1]) * (r[1:] + r[:-1]) / 2.0).sum())
        aucs.append(area / t)
    return aucs
