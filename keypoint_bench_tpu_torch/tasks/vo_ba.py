"""VO -> windowed bundle adjustment (counterpart of
keypoint_bench_tpu/tasks/vo_ba.py; the reference's VO never revisits a
pose after GT-scale chaining, tasks/visual_odometer.py:81-89).

Pipeline:
  1. consecutive-pair matches are chained into multi-frame tracks on the
     host (track ids propagate along match edges),
  2. each track is triangulated linearly from its first and last
     observation using the chained VO poses,
  3. a BAProblem over the window refines poses + points with the
     LM / Schur solver (ba/gauss_newton.py), first camera fixed, or with
     `mesh` its distributed form over the mesh's data ranks
     (ba/distributed.py).

The problem is built at its real size: the JAX package's power-of-two
bucket padding and its gate jits only keep its jit cache warm. Padded
observations there are masked and padded points have no observation, so
the unpadded problem gives the same poses, points and mean errors.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from keypoint_bench_tpu_torch.ba.distributed import (ba_solve_distributed,
                                                     gather_points)
from keypoint_bench_tpu_torch.ba.gauss_newton import (BAProblem, ba_solve,
                                                      reprojection_errors)
from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.parallel.mesh import Mesh


def chain_tracks(match_idx: np.ndarray, match_ok: np.ndarray):
    """match_idx [T, K]: for pair (i-1, i), row i maps keypoint slot k of
    frame i-1 to its matched slot in frame i (with match_ok [T, K]
    validity; row 0 is ignored). Returns a list of tracks, each a list of
    (frame, slot) observations with length >= 2.

    Vectorized per frame, with the semantics of the naive per-(frame,
    slot) loop: per frame, the lowest valid slot claiming a target j wins
    it ("first claim wins"); the losers' would-be singleton tracks are
    never read again and the length filter drops them, so only winners
    matter. Track ids are assigned in (frame, slot) order, the naive
    loop's output order."""
    t, k = np.asarray(match_idx).shape
    match_idx = np.asarray(match_idx)
    match_ok = np.asarray(match_ok, bool)
    track_of = -np.ones((t, k), np.int64)   # track id per (frame, slot)
    next_id = 0
    for i in range(1, t):
        slots = np.nonzero(match_ok[i])[0]
        if slots.size == 0:
            continue
        j = match_idx[i].astype(np.int64)
        # lowest slot per distinct target j wins (np.unique's return_index
        # picks the first occurrence; slots is ascending)
        _, first = np.unique(j[slots], return_index=True)
        winners = np.sort(slots[first])
        tid = track_of[i - 1, winners].copy()
        new = tid < 0
        tid[new] = next_id + np.arange(int(new.sum()))
        next_id += int(new.sum())
        track_of[i - 1, winners[new]] = tid[new]
        track_of[i, j[winners]] = tid
    rows, cols = np.nonzero(track_of >= 0)
    if rows.size == 0:
        return []
    tids = track_of[rows, cols]
    order = np.lexsort((rows, tids))        # by track id, frames ascending
    rt, rr, rc = tids[order], rows[order], cols[order]
    bounds = np.flatnonzero(np.diff(rt)) + 1
    tracks = [list(zip(r.tolist(), c.tolist()))
              for r, c in zip(np.split(rr, bounds), np.split(rc, bounds))]
    return [tr for tr in tracks if len(tr) >= 2]


def chain_w2c(rel_R: np.ndarray, rel_t: np.ndarray, ok: np.ndarray,
              scales):
    """World-to-camera poses of T frames from the relative poses of their
    pairs (rel_R [T,3,3], rel_t [T,3], ok [T]; pair 0 is frame 0 with
    itself and is not used), each translation scaled by the pair's GT
    scale, or 0 below 0.001 or where the pair failed (the JAX runner's BA
    chain, runner.py:1062-1075). Returns (R_w2c [T,3,3], t_w2c [T,3])."""
    R_w2c = [np.eye(3)]
    t_w2c = [np.zeros(3)]
    for i in range(1, len(rel_R)):
        s = float(scales[i]) if scales[i] >= 0.001 and ok[i] else 0.0
        R_w2c.append(rel_R[i] @ R_w2c[-1])
        t_w2c.append(rel_R[i] @ t_w2c[-1] + s * rel_t[i])
    return np.stack(R_w2c), np.stack(t_w2c)


def build_ba_problem(kpts_px: np.ndarray, tracks, R_w2c: np.ndarray,
                     t_w2c: np.ndarray, K: np.ndarray,
                     min_depth: float = 0.1, max_depth: float = 100.0,
                     device: str | torch.device = "cuda"):
    """kpts_px [T, Kslots, 2] pixel coordinates; tracks from chain_tracks;
    R_w2c/t_w2c [T,...] world->camera chained VO poses. Returns a float32
    BAProblem on `device` with one point per track whose first-camera
    depth lies in (min_depth, max_depth), or None below 8 such tracks.

    Each track is triangulated from its first and last observation by one
    batched 4x4 SVD on the host (numpy, float64)."""
    dev = resolve_device(device)
    n_tracks = len(tracks)
    if n_tracks == 0:
        return None
    lens = np.array([len(tr) for tr in tracks])
    flat = np.array([obs for tr in tracks for obs in tr], np.int64)
    tids = np.repeat(np.arange(n_tracks), lens)
    fr, sl = flat[:, 0], flat[:, 1]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    ends = np.cumsum(lens) - 1
    f0, s0 = fr[starts], sl[starts]
    f1, s1 = fr[ends], sl[ends]

    # batched linear two-view triangulation from each track's first/last obs
    P = K @ np.concatenate([R_w2c, t_w2c[:, :, None]], axis=2)   # [C, 3, 4]
    P0, P1 = P[f0], P[f1]
    uv0 = kpts_px[f0, s0]
    uv1 = kpts_px[f1, s1]
    A = np.stack([
        uv0[:, 0, None] * P0[:, 2] - P0[:, 0],
        uv0[:, 1, None] * P0[:, 2] - P0[:, 1],
        uv1[:, 0, None] * P1[:, 2] - P1[:, 0],
        uv1[:, 1, None] * P1[:, 2] - P1[:, 1],
    ], axis=1)                                                   # [T, 4, 4]
    _, _, vt = np.linalg.svd(A)
    Xh = vt[:, -1, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        X = Xh[:, :3] / Xh[:, 3:4]
    z0 = np.einsum("tij,tj->ti", R_w2c[f0], np.nan_to_num(X, nan=0.0,
                                                          posinf=0.0,
                                                          neginf=0.0))[:, 2] \
        + t_w2c[f0][:, 2]
    good = ((z0 > min_depth) & (z0 < max_depth)
            & np.isfinite(X).all(axis=1))
    if int(good.sum()) < 8:
        return None
    pid_of = -np.ones(n_tracks, np.int64)
    pid_of[good] = np.arange(int(good.sum()))
    keep = good[tids]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return BAProblem(
        R=f32(R_w2c), t=f32(t_w2c), points=f32(X[good]),
        cam_idx=torch.as_tensor(fr[keep], device=dev),
        pt_idx=torch.as_tensor(pid_of[tids[keep]], device=dev),
        uv=f32(kpts_px[fr[keep], sl[keep]]),
        mask=torch.ones(int(keep.sum()), dtype=torch.bool, device=dev),
        K=f32(K))


def gate_window(prob: BAProblem, max_init_err: float = 20.0):
    """Mask out the observations whose initial reprojection error is
    `max_init_err` px or more (wrong matches in the tracks). Returns (the
    gated problem, the mean initial error over the kept observations as a
    0-d tensor)."""
    errs = reprojection_errors(prob)
    m = prob.mask & (errs < max_init_err)
    err0 = (errs * m).sum() / torch.clamp_min(m.sum(), 1)
    return replace(prob, mask=m), err0


def refine_window(kpts_px, tracks, R_w2c, t_w2c, K, iters: int = 8,
                  max_init_err: float = 20.0, huber_delta: float = 2.0,
                  mesh=None, device: str | torch.device = "cuda"):
    """Run windowed BA; returns (R [C,3,3], t [C,3], points [P,3] as numpy
    float32, err_before, err_after) or None when the window has too few
    tracks. Observations whose initial reprojection error exceeds
    `max_init_err` px are masked out; the solve uses Huber reweighting and
    damping 1e-2. With `mesh` (a parallel.mesh.Mesh whose every data rank
    calls this with the same window) the solve is `ba_solve_distributed`,
    with the same semantics, and every rank returns the same result."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    prob = build_ba_problem(kpts_px, tracks, R_w2c, t_w2c, K, device=device)
    if prob is None:
        return None
    prob, err0 = gate_window(prob, max_init_err)
    if mesh is None:
        R, t, p, err = ba_solve(prob, iters=iters, damping=1e-2,
                                huber_delta=huber_delta)
    else:
        R, t, s_pts, meta = ba_solve_distributed(
            mesh, prob, iters=iters, damping=1e-2, huber_delta=huber_delta)
        p = gather_points(s_pts, meta, prob.points.shape[0])
        err = reprojection_errors(replace(prob, R=R, t=t, points=p)).sum() \
            / torch.clamp_min(prob.mask.sum(), 1)
    return (R.cpu().numpy(), t.cpu().numpy(), p.cpu().numpy(), float(err0),
            float(err))
