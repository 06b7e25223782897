"""SE3 helpers the sequence datasets need: the port's own copy of
`inv_T`, `skew`, `pose_to_fundamental`, `quat_to_rotmat` and `make_T` of
keypoint_bench_tpu/geometry/se3.py. Numpy only, float64 like the original."""
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


def make_T(R, t):
    """(R [3,3], t [3]) -> homogeneous [4,4]."""
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.reshape(t, 3)
    return T
