"""IMU preintegration between camera frames (counterpart of
keypoint_bench_tpu/tasks/imu.py).

Discrete preintegration of gyro / accel samples on SO3 x R^3: the delta
rotation, velocity and position between two timestamps, usable as a
motion prior for VO scale or pose-graph edges. JAX's `lax.scan` over the
samples is a loop here; the per-sample rotations come from one batched
`_exp_so3`. Computes in the inputs' dtype.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.ba.gauss_newton import _exp_so3

# float32, as the JAX package's constant is
GRAVITY = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float32)


def preintegrate(gyro: torch.Tensor, accel: torch.Tensor, dts: torch.Tensor,
                 mask: torch.Tensor) -> dict:
    """Integrate IMU samples into frame-to-frame deltas.

    gyro, accel: [N, 3] (rad/s, m/s^2 in body frame); dts [N] seconds between
    consecutive samples; mask [N] selects the samples of this interval.
    Returns dict with dR [3,3] (body rotation over the interval), dv [3],
    dp [3] (velocity/position deltas in the initial body frame, gravity NOT
    removed — subtract R0^T g dt terms at use site), dt total.
    """
    m = mask.to(torch.float32)
    dt = dts * m
    dRs = _exp_so3(gyro * dt[:, None])
    R = torch.eye(3, dtype=dRs.dtype, device=gyro.device)
    v = torch.zeros(3, dtype=dRs.dtype, device=gyro.device)
    p = torch.zeros_like(v)
    for k in range(gyro.shape[0]):
        a_world = R @ accel[k]
        p = p + v * dt[k] + 0.5 * a_world * dt[k] * dt[k]
        v = v + a_world * dt[k]
        R = R @ dRs[k]
    return {"dR": R, "dv": v, "dp": p, "dt": torch.sum(dts * m)}


def gravity_aligned_deltas(pre: dict, R_wb0: torch.Tensor,
                           v0: torch.Tensor):
    """Convert body-frame preintegrated deltas into world-frame motion given
    the initial orientation R_wb0 (world-from-body) and velocity v0:
        p1 = p0 + v0 dt + 1/2 g dt^2 + R_wb0 dp
        v1 = v0 + g dt + R_wb0 dv
    Returns (dp_world, dv_world) including gravity."""
    dt = pre["dt"]
    g = GRAVITY.to(device=dt.device, dtype=torch.promote_types(
        dt.dtype, GRAVITY.dtype))
    dp = v0 * dt + 0.5 * g * dt * dt + R_wb0 @ pre["dp"]
    dv = g * dt + R_wb0 @ pre["dv"]
    return dp, dv
