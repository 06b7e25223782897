"""Bundle adjustment: Levenberg-Marquardt with Schur-complement reduction
(counterpart of keypoint_bench_tpu/ba/gauss_newton.py).

Problem layout:
  poses:   [C, 3, 3] R + [C, 3] t   (world -> camera)
  points:  [P, 3]
  obs:     cam_idx [N], pt_idx [N], uv [N, 2] pixels, mask [N]
  K:       [3, 3] shared intrinsics

Each iteration, as batched tensor algebra over the N observations:
  * residuals and analytic Jacobians wrt the 6-dof left se3 perturbation
    of the camera (translation first) and the 3-dof point,
  * H_pp (3x3 per point), H_cc (6x6 per camera) and the cross blocks W,
    summed over the observations in a fixed order (`_segment_sum`),
  * the reduced camera system S = H_cc - sum_p W_p H_pp^-1 W_p^T (a dense
    6C x 6C solve; C is the window's frame count), the first camera fixed
    by exact elimination,
  * point back-substitution, then the LM accept/reject of the (robust)
    cost and the damping update, both on the device (no host sync).
The tensors' dtype (float32 or float64) is the problem's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class BAProblem:
    R: torch.Tensor        # [C, 3, 3] world->cam rotations
    t: torch.Tensor        # [C, 3]
    points: torch.Tensor   # [P, 3]
    cam_idx: torch.Tensor  # [N] long
    pt_idx: torch.Tensor   # [N] long
    uv: torch.Tensor       # [N, 2] pixel observations
    mask: torch.Tensor     # [N] bool
    K: torch.Tensor        # [3, 3]


def _hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrices [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1)], dim=-2)


def _exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues, [..., 3] -> [..., 3, 3], with the Taylor branch below
    theta^2 = 1e-10 (and a safe theta^2 in the other branch's operands).
    theta^2 keeps a trailing dim: under forward-mode AD (the pose graph's
    jacfwd) a 0-d tensor's tangent turns float64 where a Python scalar
    meets it."""
    th2 = (phi * phi).sum(-1, keepdim=True)
    small = th2 < 1e-10
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    ph = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a[..., None] * ph + b[..., None] * (ph @ ph)


def _project(K: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Camera points [..., 3] -> pixels [..., 2] (depth clamped at 1e-6)."""
    z = torch.clamp_min(Xc[..., 2], 1e-6)
    u = K[0, 0] * Xc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / z + K[1, 2]
    return torch.stack([u, v], dim=-1)


def _to_camera(R, t, X):
    """R [..., 3, 3], t [..., 3], X [..., 3] -> R X + t [..., 3]."""
    return (R @ X[..., None])[..., 0] + t


def _residual_and_jac(K, R, t, X, uv):
    """Per observation: r [..., 2], J_cam [..., 2, 6] (left perturbation,
    translation first), J_pt [..., 2, 3]."""
    Xc = _to_camera(R, t, X)
    z = torch.clamp_min(Xc[..., 2], 1e-6)
    r = _project(K, Xc) - uv
    fx, fy = K[0, 0], K[1, 1]
    zero = torch.zeros_like(z)
    # d(pi)/dXc
    Jpi = torch.stack([
        torch.stack([fx / z, zero, -fx * Xc[..., 0] / z ** 2], dim=-1),
        torch.stack([zero, fy / z, -fy * Xc[..., 1] / z ** 2], dim=-1)],
        dim=-2)
    # dXc/d(delta) for Xc' = exp(delta) o (R X + t): [I | -[Xc]x]
    Jcam = torch.cat([Jpi, -(Jpi @ _hat(Xc))], dim=-1)
    return r, Jcam, Jpi @ R


def _obs_residuals(prob: BAProblem, R, t, pts) -> torch.Tensor:
    """|pi(R_c X_p + t_c) - uv| for every observation, [N]."""
    Xc = _to_camera(R[prob.cam_idx], t[prob.cam_idx], pts[prob.pt_idx])
    return torch.linalg.vector_norm(_project(prob.K, Xc) - prob.uv, dim=-1)


def reprojection_errors(prob: BAProblem) -> torch.Tensor:
    """Per-observation reprojection error [N] in pixels, 0 where masked."""
    errs = _obs_residuals(prob, prob.R, prob.t, prob.points)
    return torch.where(prob.mask, errs, torch.zeros_like(errs))


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of x [N, ...] summed by idx [N] into [n, ...], in the same
    order on every run. index_add_ is so on the CPU; on CUDA its atomics
    sum in an undefined order, and the LM accept test on near-equal costs
    then flips from run to run, so CUDA tensors take index_put_ with
    accumulate, which sorts the indices and sums each segment in turn
    (on the CPU that one is the threaded, unordered one)."""
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    if x.is_cuda:
        return out.index_put_((idx,), x, accumulate=True)
    return out.index_add_(0, idx, x)


def lm_iterations(prob: BAProblem, iters: int = 10, damping: float = 1e-4,
                  fix_first_cam: bool = True, huber_delta: float = 0.0):
    """`iters` damped Gauss-Newton / Schur iterations with the LM
    accept/reject (see `ba_solve`). Returns (R, t, points, accepted
    [iters] bool): whether each iteration's step was taken."""
    C = prob.R.shape[0]
    P = prob.points.shape[0]
    dt = prob.R.dtype
    dev = prob.R.device
    wmask = prob.mask.to(dt)
    ci, pi = prob.cam_idx, prob.pt_idx
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def cost(R, t, pts):
        rn = _obs_residuals(prob, R, t, pts)
        if huber_delta > 0:
            rho = torch.where(rn <= huber_delta, 0.5 * rn * rn,
                              huber_delta * (rn - 0.5 * huber_delta))
        else:
            rho = 0.5 * rn * rn
        return (wmask * rho).sum()

    R, t, pts = prob.R, prob.t, prob.points
    # filled on the device: a copy from the host would synchronize
    lam = torch.full((), float(damping), dtype=dt, device=dev)
    accepted = []
    for _ in range(iters):
        r, Jc, Jp = _residual_and_jac(prob.K, R[ci], t[ci], pts[pi], prob.uv)
        m = wmask
        if huber_delta > 0:
            rn = torch.linalg.vector_norm(r, dim=-1) + 1e-12
            m = m * torch.sqrt(torch.clamp_max(huber_delta / rn, 1.0))
        r = r * m[:, None]
        Jc = Jc * m[:, None, None]
        Jp = Jp * m[:, None, None]
        JcT, JpT = Jc.transpose(-1, -2), Jp.transpose(-1, -2)
        Hcc = _segment_sum(JcT @ Jc, ci, C)                      # [C,6,6]
        Hpp = _segment_sum(JpT @ Jp, pi, P)                      # [P,3,3]
        bc = -_segment_sum((JcT @ r[..., None])[..., 0], ci, C)  # [C,6]
        bp = -_segment_sum((JpT @ r[..., None])[..., 0], pi, P)  # [P,3]

        # LM damping with the adaptive lambda carried across iterations
        Hpp = Hpp + lam * eye3
        Hcc = Hcc + lam * eye6
        Hpp_inv = torch.linalg.inv_ex(Hpp)[0]                   # [P,3,3]

        # Schur: W holds each (point, camera) cross block, summed over the
        # observations through the fused index p * C + c
        W = _segment_sum(JcT @ Jp, pi * C + ci, P * C).reshape(P, C, 6, 3)
        WH = torch.einsum("pcij,pjk->pcik", W, Hpp_inv)
        S = -torch.einsum("pcik,pdlk->cdil", WH, W)              # [C,C,6,6]
        S.diagonal(0, 0, 1).add_(Hcc.permute(1, 2, 0))
        rhs = bc - torch.einsum("pcik,pk->ci", WH, bp)

        Sd = S.transpose(1, 2).reshape(6 * C, 6 * C)
        rd = rhs.reshape(6 * C)
        if fix_first_cam:
            # gauge fix by exact elimination: zero cam0's rows/cols,
            # identity diagonal, zero rhs (a huge prior destroys f32
            # conditioning on real problems)
            Sd[:6, :] = 0.0
            Sd[:, :6] = 0.0
            Sd[:6, :6] = eye6
            rd[:6] = 0.0
        dx = torch.linalg.solve_ex(Sd, rd)[0].reshape(C, 6)

        # back-substitute points: dp = Hpp^-1 (bp - sum_c W^T dx_c)
        Wt_dx = torch.einsum("pcij,ci->pj", W, dx)
        dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - Wt_dx)

        dR = _exp_so3(dx[:, 3:6])
        Rn = dR @ R
        tn = (dR @ t[..., None])[..., 0] + dx[:, 0:3]
        ptsn = pts + dp

        # keep the step only if the (robust) cost decreased; otherwise stay
        # and raise lambda
        c_new = cost(Rn, tn, ptsn)
        accept = torch.isfinite(c_new) & (c_new < cost(R, t, pts))
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        pts = torch.where(accept, ptsn, pts)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 10.0),
                          1e-6, 1e6)
        accepted.append(accept)
    return R, t, pts, (torch.stack(accepted) if accepted else
                       torch.zeros(0, dtype=torch.bool, device=dev))


def ba_solve(prob: BAProblem, iters: int = 10, damping: float = 1e-4,
             fix_first_cam: bool = True, huber_delta: float = 0.0):
    """Run `iters` damped GN/Schur iterations. Returns the updated (R, t,
    points, final mean reprojection error over valid observations), all
    on the problem's device. huber_delta > 0 enables a robust (Huber)
    reweighting of each observation, for observations that come from real
    matching with outlier tracks."""
    R, t, pts, _ = lm_iterations(prob, iters, damping, fix_first_cam,
                                 huber_delta)
    errs = reprojection_errors(replace(prob, R=R, t=t, points=pts))
    mean_err = errs.sum() / torch.clamp_min(prob.mask.sum(), 1)
    return R, t, pts, mean_err
