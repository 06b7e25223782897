"""Pose-graph optimization: Gauss-Newton over SE3 poses with relative-pose
constraints (counterpart of keypoint_bench_tpu/ba/pose_graph.py).

Residual per edge (i, j) with measurement T_ij (i -> j):
    r = Log( T_ij^-1 * (T_j * T_i^-1) )   in R^6 (translation, rotation)
The JAX package takes the Jacobians wrt the left-multiplied tangent
perturbations of T_i and T_j by jax.jacfwd of this residual. Here they are
that forward-mode derivative written out for all edges at once
(`_linearize`): the tangent of exp(phi) at 0 is [phi]x, carried through
the residual's own formula, the small-angle branch of its SO3 log
included. tests/test_torch_pose_graph.py holds them against
`torch.func.jacfwd` under `vmap` of `_edge_residual` and against JAX's.
The normal system over all poses is assembled with the ordered segment
sums of ba/gauss_newton.py and solved densely (pose counts are
keyframe-scale), the first pose gauge-fixed. A fixed number of
iterations, with no host sync inside; the tensors' dtype is the graph's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from keypoint_bench_tpu_torch.ba.gauss_newton import (_exp_so3, _hat,
                                                      _segment_sum)


@dataclass
class PoseGraph:
    R: torch.Tensor        # [N, 3, 3]
    t: torch.Tensor        # [N, 3]
    edge_i: torch.Tensor   # [E] long
    edge_j: torch.Tensor   # [E] long
    meas_R: torch.Tensor   # [E, 3, 3] measured R of T_ij (i -> j)
    meas_t: torch.Tensor   # [E, 3]
    weight: torch.Tensor   # [E] scalar information weight


def _vee(A: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]: (A21 - A12, A02 - A20, A10 - A01), the
    log's axis term."""
    return torch.stack([A[..., 2, 1] - A[..., 1, 2],
                        A[..., 0, 2] - A[..., 2, 0],
                        A[..., 1, 0] - A[..., 0, 1]], dim=-1)


def _log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO3 log, [..., 3, 3] -> [..., 3], with a Taylor-safe small-angle
    branch (double where: arccos' derivative diverges at cos = 1, which is
    the linearization point of a converged pose graph)."""
    # [..., 1], not 0-d: see gauss_newton._exp_so3
    tr = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    c = torch.clamp((tr - 1) / 2, -1.0, 1.0)
    small = c > 1.0 - 1e-7
    c_safe = torch.where(small, torch.zeros_like(c), c)
    th = torch.arccos(c_safe)
    s_exact = th / (2.0 * torch.sin(th) + 1e-12)
    s_taylor = 0.5 + (1.0 - c) / 6.0  # theta/(2 sin theta) ~ 1/2 + th^2/12
    s = torch.where(small, s_taylor, s_exact)
    return s * _vee(R)


def _apply_tangent(R: torch.Tensor, t: torch.Tensor, d: torch.Tensor):
    """Left perturbation of (R [..., 3, 3], t [..., 3]) by d [..., 6]
    (translation first): (exp(phi) R, exp(phi) t + rho)."""
    rot = _exp_so3(d[..., 3:6])
    return rot @ R, (rot @ t[..., None])[..., 0] + d[..., 0:3]


def _edge_residual(Ri, ti, Rj, tj, mR, mt, di, dj):
    """Residual [..., 6] of edges after tangent perturbations di, dj."""
    Ri, ti = _apply_tangent(Ri, ti, di)
    Rj, tj = _apply_tangent(Rj, tj, dj)
    # relative j-from-i: T_j * T_i^-1
    R_rel = Rj @ Ri.transpose(-1, -2)
    t_rel = tj - (R_rel @ ti[..., None])[..., 0]
    # error transform: meas^-1 * rel
    mRt = mR.transpose(-1, -2)
    R_err = mRt @ R_rel
    t_err = (mRt @ (t_rel - mt)[..., None])[..., 0]
    return torch.cat([t_err, _log_so3(R_err)], dim=-1)


def _linearize(R, t, g: PoseGraph):
    """Weighted residuals [E, 6] and Jacobians [E, 6, 6] wrt the tangents
    (translation, rotation) of T_i and of T_j: the forward-mode derivative
    of `_edge_residual` at zero tangents, every edge and direction at
    once."""
    Ri, ti, Rj, tj = R[g.edge_i], t[g.edge_i], R[g.edge_j], t[g.edge_j]
    mRt = g.meas_R.transpose(-1, -2)
    R_rel = Rj @ Ri.transpose(-1, -2)
    t_rel = tj - (R_rel @ ti[..., None])[..., 0]
    R_err = mRt @ R_rel
    t_err = (mRt @ (t_rel - g.meas_t)[..., None])[..., 0]
    # the log's scalar s(c) and its derivative, branch by branch as
    # `_log_so3` computes them
    tr = R_err[..., 0, 0:1] + R_err[..., 1, 1:2] + R_err[..., 2, 2:3]
    c_raw = (tr - 1) / 2
    c = torch.clamp(c_raw, -1.0, 1.0)
    inside = ((c_raw >= -1.0) & (c_raw <= 1.0)).to(c)   # clamp's derivative
    small = c > 1.0 - 1e-7
    c_safe = torch.where(small, torch.zeros_like(c), c)
    th = torch.arccos(c_safe)
    den = 2.0 * torch.sin(th) + 1e-12
    s = torch.where(small, 0.5 + (1.0 - c) / 6.0, th / den)
    dth = -1.0 / torch.sqrt(1.0 - c_safe * c_safe)
    ds_dc = inside * torch.where(
        small, torch.full_like(c, -1.0 / 6.0),
        (den - th * 2.0 * torch.cos(th)) / (den * den) * dth)
    w = _vee(R_err)
    r = torch.cat([t_err, s * w], dim=-1)

    def rot_rows(dR_rel):
        """Rotation rows [E, 3, 3 directions] from dR_rel [E, 3, 3, 3]."""
        dR = mRt[:, None] @ dR_rel
        dc = (dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]) / 2
        return (ds_dc[:, None] * dc[..., None] * w[:, None] + s[:, None]
                * _vee(dR)).transpose(1, 2)

    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    H = _hat(eye)                                   # [3, 3, 3]: [e_k]x
    zeros = torch.zeros_like(R_err)
    # direction k of phi_j: dR_rel = [e_k]x R_rel, dt_rel = [e_k]x t_rel;
    # of phi_i: dR_rel = -R_rel [e_k]x, dt_rel = 0 (T_i^-1 t_i cancels);
    # of rho_j: dt_rel = e_k; of rho_i: dt_rel = -R_rel e_k
    Jj = torch.cat([
        torch.cat([mRt, mRt @ (H @ t_rel[:, None, :, None])[..., 0]
                   .transpose(1, 2)], dim=-1),
        torch.cat([zeros, rot_rows(H @ R_rel[:, None])], dim=-1)], dim=1)
    Ji = torch.cat([
        torch.cat([-(mRt @ R_rel), zeros], dim=-1),
        torch.cat([zeros, rot_rows(-(R_rel[:, None] @ H))], dim=-1)], dim=1)
    w_e = g.weight[:, None]
    return r * w_e, Ji * w_e[..., None], Jj * w_e[..., None]


def _normal_step(R, t, g: PoseGraph, damping: float) -> torch.Tensor:
    """The Gauss-Newton step dx [n, 6] of one iteration: H and b summed
    over the edges in a fixed order, pose 0 eliminated exactly, one dense
    [6n, 6n] solve."""
    n = R.shape[0]
    ei, ej = g.edge_i, g.edge_j
    r, Ji, Jj = _linearize(R, t, g)
    Hii = Ji.transpose(1, 2) @ Ji
    Hjj = Jj.transpose(1, 2) @ Jj
    Hij = Ji.transpose(1, 2) @ Jj
    bi = -(Ji.transpose(1, 2) @ r[..., None])[..., 0]
    bj = -(Jj.transpose(1, 2) @ r[..., None])[..., 0]
    # the JAX package's scatter-adds in its order: Hii, Hjj, Hij, Hij^T
    H = _segment_sum(torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)]),
                     torch.cat([ei * n + ei, ej * n + ej, ei * n + ej,
                                ej * n + ei]), n * n)
    b = _segment_sum(torch.cat([bi, bj]), torch.cat([ei, ej]), n)
    Hd = H.reshape(n, n, 6, 6).transpose(1, 2).reshape(6 * n, 6 * n)
    eye = torch.eye(6 * n, dtype=R.dtype, device=R.device)
    Hd = Hd + damping * eye
    # gauge fix by exact elimination of pose 0
    keep = torch.ones(6 * n, dtype=R.dtype, device=R.device)
    keep[:6] = 0.0
    Hd = Hd * keep[:, None] * keep[None, :] + eye * (1.0 - keep)[:, None]
    b = b.reshape(-1) * keep
    # solve_ex: no singularity check, so no read of its info on the host
    return torch.linalg.solve_ex(Hd, b)[0].reshape(n, 6)


def pgo_solve(g: PoseGraph, iters: int = 10, damping: float = 1e-6):
    """Run `iters` Gauss-Newton iterations; returns (R [N, 3, 3], t [N, 3],
    the final mean residual norm as a 0-d tensor)."""
    R, t = g.R, g.t
    for _ in range(iters):
        dx = _normal_step(R, t, g, damping)
        R, t = _apply_tangent(R, t, dx)
    zero6 = torch.zeros((len(g.edge_i), 6), dtype=R.dtype, device=R.device)
    res = _edge_residual(R[g.edge_i], t[g.edge_i], R[g.edge_j], t[g.edge_j],
                         g.meas_R, g.meas_t, zero6, zero6)
    return R, t, torch.linalg.vector_norm(res, dim=-1).mean()
