"""SE3 helpers: the port's own copy of keypoint_bench_tpu/geometry/se3.py
(`inv_T`, `skew`, `pose_to_fundamental`, `quat_to_rotmat`,
`rotmat_to_quat`, `make_T`, `relative_pose`). Numpy only, float64 like the
original; quaternions are (x, y, z, w), the order of the KITTI, TartanAir
and EuRoC ground-truth files."""
from __future__ import annotations

import numpy as np


def inv_T(T):
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = np.eye(4)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti


def skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


def pose_to_fundamental(T_01, K0, K1):
    """GT fundamental matrix from a relative pose (reference
    datasets/kitti.py:10-22): F = K1^-T [t]_x R K0^-1 for x1^T F x0 = 0."""
    R = T_01[:3, :3]
    t = T_01[:3, 3]
    E = skew(t) @ R
    return np.linalg.inv(K1).T @ E @ np.linalg.inv(K0)


def quat_to_rotmat(q):
    """Quaternion (x, y, z, w) -> rotation matrix [3,3]."""
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_quat(R):
    """Rotation matrix [3,3] -> quaternion (x, y, z, w)."""
    R = np.asarray(R)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def make_T(R, t):
    """(R [3,3], t [3]) -> homogeneous [4,4]."""
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.reshape(t, 3)
    return T


def relative_pose(T_w0, T_w1):
    """World-from-cam poses [4,4] -> T_01 mapping cam0 points into cam1."""
    return inv_T(T_w1) @ T_w0
