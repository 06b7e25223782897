"""Monocular visual odometry with GT-scale injection (counterpart of
keypoint_bench_tpu/tasks/vo.py; reference tasks/visual_odometer.py:10-96).

Per frame pair: essential RANSAC + recoverPose on the matches at (focal,
pp), batched over pairs on the device; then, on the host, the chain
    scale = ||t_gt - t_gt_prev||
    if scale >= 0.001:  R_est = R_prev @ R ; t_est = t_prev + scale * R_prev @ t
"""
from __future__ import annotations

import numpy as np
import torch

from keypoint_bench_tpu_torch.geometry.ransac import (
    _sample_minimal, ransac_essential_from_samples, recover_pose)


def vo_pair_pose(m_pts0_px: torch.Tensor, m_pts1_px: torch.Tensor,
                 match_mask: torch.Tensor, fx, cx, cy,
                 generator: torch.Generator | None, n_hyp: int = 4096,
                 thresh_px: float = 1.0,
                 samples: torch.Tensor | None = None):
    """Relative pose of frame pairs from matched pixel coordinates
    m_pts0_px/m_pts1_px [..., K, 2] with match_mask [..., K]. A
    single-focal pinhole like cv2.findEssentialMat(focal, pp)
    (visual_odometer.py:75-79): x and y are both divided by fx after
    subtracting (cx, cy), and the Sampson threshold is thresh_px / fx.
    fx, cx, cy are scalars or [...]. The minimal samples [..., n_hyp, 8]
    come from `generator` (on the tensors' device), or are given as
    `samples`. Returns (R [..., 3, 3], t [..., 3], n_inliers [...], ok
    [...]); `ok` is RANSAC's own."""
    dev = m_pts0_px.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    fx, cx, cy = f32(fx), f32(cx), f32(cy)
    pp = torch.stack(torch.broadcast_tensors(cx, cy), dim=-1)[..., None, :]
    p0n = (m_pts0_px - pp) / fx[..., None, None]
    p1n = (m_pts1_px - pp) / fx[..., None, None]
    if samples is None:
        samples = _sample_minimal(match_mask, n_hyp, 8, generator)
    E, inl, ok = ransac_essential_from_samples(p0n, p1n, match_mask, samples,
                                               thresh_px / fx)
    R, t, _, n_in = recover_pose(E, p0n, p1n, inl)
    return R, t, n_in, ok


def chain_poses(rel_R: np.ndarray, rel_t: np.ndarray, ok: np.ndarray,
                scales: np.ndarray):
    """Host-side pose chaining over the whole sequence (the only serial
    part). rel_R [T,3,3], rel_t [T,3], ok [T], scales [T] =
    ||t_gt_i - t_gt_{i-1}||. Returns (R_est [T+1,3,3], t_est [T+1,3,1])
    starting at identity, the update rule of visual_odometer.py:81-89."""
    R_list = [np.eye(3)]
    t_list = [np.zeros((3, 1))]
    for i in range(rel_R.shape[0]):
        R_prev, t_prev = R_list[-1], t_list[-1]
        if ok[i] and scales[i] >= 0.001:
            R_new = R_prev @ rel_R[i]
            t_new = t_prev + float(scales[i]) * (R_prev @ rel_t[i][:, None])
        else:
            R_new, t_new = R_prev, t_prev
        R_list.append(R_new)
        t_list.append(t_new)
    return np.stack(R_list), np.stack(t_list)


def write_kitti_trajectory(path: str, R_est: np.ndarray, t_est: np.ndarray):
    """KITTI 12-number-per-line pose file (reference
    utils/visualization.py:209-224 write_position equivalent)."""
    with open(path, "w") as f:
        for R, t in zip(R_est, t_est):
            m = np.concatenate([R, t.reshape(3, 1)], axis=1)
            f.write(" ".join(str(float(v)) for v in m.reshape(-1)) + "\n")
