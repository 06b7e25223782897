"""Distributed bundle adjustment over the mesh's 'data' ranks (counterpart
of keypoint_bench_tpu/ba/distributed.py).

Landmarks, and all their observations, are dealt round-robin to the data
ranks. Each rank builds its shard's H_pp, W and Schur contributions to
the reduced 6C x 6C camera system; one all_reduce a Levenberg-Marquardt
iteration sums them (the camera blocks, the Schur cross terms and the
right-hand side in one buffer); every rank solves the small system
redundantly (C is a keyframe window) and back-substitutes its own points.
The robust (Huber) cost of the accept test is the sum of the shards'
costs, one more all_reduce of two scalars, so every rank takes the same
decision. The loop is `ba/gauss_newton.lm_iterations` itself, given the
shard and the all_reduce as its `psum`; the float sums run in another
order across shards.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from keypoint_bench_tpu_torch.ba.gauss_newton import (BAProblem,
                                                      lm_iterations)
from keypoint_bench_tpu_torch.parallel.mesh import Mesh


def partition_problem(prob: BAProblem, n_shards: int):
    """On the host: points round-robin to shards (point p to shard
    p % n_shards at local slot p // n_shards), each observation to its
    point's shard, every shard padded to equal sizes (padded observations
    masked, padded points at the origin with none). Returns ((points
    [n, p_local, 3], cam_idx [n, n_obs], local pt_idx [n, n_obs], uv
    [n, n_obs, 2], mask [n, n_obs]) on the problem's device, meta)."""
    cam_idx = prob.cam_idx.cpu().numpy()
    pt_idx = prob.pt_idx.cpu().numpy()
    uv = prob.uv.cpu().numpy()
    mask = prob.mask.cpu().numpy()
    points = prob.points.cpu().numpy()
    n_pts = points.shape[0]

    shard_of_pt = np.arange(n_pts) % n_shards
    local_of_pt = np.arange(n_pts) // n_shards
    p_local = -(-n_pts // n_shards)
    obs_shard = shard_of_pt[pt_idx]
    n_local = max(int(np.max(np.bincount(obs_shard, minlength=n_shards),
                             initial=0)), 1)

    s_pts = np.zeros((n_shards, p_local, 3), points.dtype)
    s_cam = np.zeros((n_shards, n_local), np.int64)
    s_pt = np.zeros((n_shards, n_local), np.int64)
    s_uv = np.zeros((n_shards, n_local, 2), uv.dtype)
    s_mask = np.zeros((n_shards, n_local), bool)
    for s in range(n_shards):
        mine = np.flatnonzero(shard_of_pt == s)
        s_pts[s, local_of_pt[mine]] = points[mine]
        rows = np.flatnonzero(obs_shard == s)
        s_cam[s, :len(rows)] = cam_idx[rows]
        s_pt[s, :len(rows)] = local_of_pt[pt_idx[rows]]
        s_uv[s, :len(rows)] = uv[rows]
        s_mask[s, :len(rows)] = mask[rows]
    meta = {"shard_of_pt": shard_of_pt, "local_of_pt": local_of_pt,
            "p_local": p_local}
    dev = prob.points.device
    return tuple(torch.as_tensor(a, device=dev) for a in (
        s_pts, s_cam, s_pt, s_uv, s_mask)), meta


def gather_points(s_points: torch.Tensor, meta: dict,
                  n_points: int) -> torch.Tensor:
    """Invert the partition: [n_shards, p_local, 3] -> [n_points, 3]."""
    return s_points[torch.as_tensor(meta["shard_of_pt"][:n_points]),
                    torch.as_tensor(meta["local_of_pt"][:n_points])]


def ba_solve_distributed(mesh: Mesh, prob: BAProblem, iters: int = 10,
                         damping: float = 1e-4, fix_first_cam: bool = True,
                         huber_delta: float = 0.0):
    """`iters` LM / Schur iterations over the mesh's data ranks (every
    rank passes the same problem, on its device): `lm_iterations` on this
    rank's shard, its sums over the shards by all_reduce. Returns (R
    [C,3,3], t [C,3], every shard's points [n_shards, p_local, 3], meta),
    the same on every rank; `gather_points` orders the points as the
    problem's."""
    (s_pts, s_cam, s_pt, s_uv, s_mask), meta = partition_problem(
        prob, mesh.n_data)
    r = mesh.data_rank
    shard = replace(prob, points=s_pts[r], cam_idx=s_cam[r], pt_idx=s_pt[r],
                    uv=s_uv[r], mask=s_mask[r])
    R, t, pts, _ = lm_iterations(
        shard, iters, damping, fix_first_cam, huber_delta,
        psum=lambda x: mesh.all_reduce(x, "data"))
    return R, t, torch.stack(mesh.all_gather(pts, "data")), meta
