"""Sequence-dataset helpers (counterpart of keypoint_bench_tpu/datasets/
sequences.py). Only the per-frame ground-truth fundamental matrices are
ported; the file-backed loaders (KITTI, TartanAir, EuRoC, ...) are not
(ROADMAP.md, Queue 1)."""
from __future__ import annotations

import numpy as np

from keypoint_bench_tpu_torch.geometry import se3


def _fundamentals_from_poses(Ts, fx, fy, cx, cy):
    """Per-frame F[i] with x_i^T F x_{i-1} = 0 from world-from-cam poses
    (reference datasets/kitti.py:10-22: dp = Inv(pose[i+1]) * pose[i]);
    F[0] is zero."""
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Fs = [np.zeros((3, 3))]
    for i in range(len(Ts) - 1):
        dp = se3.inv_T(Ts[i + 1]) @ Ts[i]
        Fs.append(se3.pose_to_fundamental(dp, K, K))
    return np.stack(Fs).astype("float32")
