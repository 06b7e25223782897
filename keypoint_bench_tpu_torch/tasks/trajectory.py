"""Trajectory evaluation: ATE with Umeyama alignment (counterpart of
keypoint_bench_tpu/tasks/trajectory.py, the in-framework replacement for
the `evo_ape` / `evo_traj` tools the reference defers to,
tasks/visual_odometer.py:94-96). Host numpy, float64.
"""
from __future__ import annotations

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity (s, R, t) aligning est -> gt; inputs [N, 3].
    Returns (s, R [3,3], t [3])."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (xe ** 2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(t_est: np.ndarray, t_gt: np.ndarray, align: bool = True,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE over positions [N, 3] (evo_ape -a
    semantics)."""
    est = np.asarray(t_est).reshape(-1, 3)
    gt = np.asarray(t_gt).reshape(-1, 3)
    if align:
        s, R, t = umeyama_align(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def read_kitti_trajectory(path: str):
    """Read a KITTI pose file -> (R [N,3,3], t [N,3])."""
    Rs, ts = [], []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) < 12:
                continue
            m = np.array(v[:12]).reshape(3, 4)
            Rs.append(m[:, :3])
            ts.append(m[:, 3])
    return np.stack(Rs), np.stack(ts)
