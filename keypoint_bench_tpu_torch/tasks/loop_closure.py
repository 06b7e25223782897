"""Loop closure for monocular VO: place recognition + pose-graph correction
(counterpart of keypoint_bench_tpu/tasks/loop_closure.py).

Monocular closures are scale-ambiguous (an essential matrix gives unit
translation only, and degenerates entirely when the revisit is nearly
coincident), so this implements the classical robust recipe:

  * candidate pairs = non-adjacent frames whose descriptor sets mutually
    match strongly,
  * "strong" closures = candidates whose median match flow is tiny — the
    camera is back at (almost) the same pose; the relative rotation is
    estimated scale-free by Kabsch alignment of the matched bearing rays and
    the translation constraint is zero,
  * those edges feed pose-graph optimization (ba/pose_graph.py) to pull the
    drifted chain shut.

The host-side decisions (Kabsch, the scale votes, `refine_closure`, the
drift gates) are the JAX package's numpy. The device work is batched where
the JAX package makes one call and one host read per frame pair:
  * every frame pair with a gap of at least `min_gap` (and, in the scaled
    path without images, every frame's odometry neighbour) is matched by
    batched `mutual_nn_match` calls over [P, K, D], up to
    MATCH_PAIRS_PER_CALL pairs a call (one launch of kernel D each on the
    card), the indices and masks read back together; each batch row is
    independent, so the closures are the ones a per-pair loop finds;
  * the scaled path's RANSAC-E and recoverPose run once over all parallax
    candidates, its neighbour tracks (with `images`) are one
    `optical_flow_batch_from_angles` call over the frames that need depths
    (kernel F), and the neighbour triangulation one batched call.
Randomness comes from an explicit `torch.Generator` (where JAX takes a
key); `draw_samples` and `angles` take given draws instead, as the RANSAC
and LK functions' `*_from_samples` / `*_from_angles` forms do.
"""
from __future__ import annotations

import numpy as np
import torch

from keypoint_bench_tpu_torch.ba.pose_graph import PoseGraph, pgo_solve
from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.geometry.ransac import (
    _sample_minimal, _triangulate_depths, ransac_essential_from_samples,
    recover_pose)
from keypoint_bench_tpu_torch.ops.lk import (LKParams, draw_angles,
                                             optical_flow_batch_from_angles)
from keypoint_bench_tpu_torch.ops.matching import mutual_nn_match

# the neighbour tracks of the scaled path (JAX loop_closure.py:146)
NEIGHBOUR_LK = LKParams(distance=10.0, win_size=21, levels=3, iterations=40)
# frame pairs matched by one `mutual_nn_match` call: memory grows with the
# pairs, not with the sequence (at K = 1000, D = 64 a call gathers ~0.5 GB
# of descriptors on CUDA; the CPU's dense form holds ~6 GB of [P, K, K])
MATCH_PAIRS_PER_CALL = 512


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to(x, device, dtype=None) -> torch.Tensor:
    """A host array or tensor on `device`; to CUDA through pinned memory
    and an asynchronous copy, so that the host does not wait for the
    card (a pageable copy would)."""
    t = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                        dtype=dtype)
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _stacked(xs) -> torch.Tensor:
    """A [T, ...] tensor of per-frame tensors or arrays."""
    if isinstance(xs, torch.Tensor):
        return xs
    return torch.stack([x if isinstance(x, torch.Tensor)
                        else torch.as_tensor(np.asarray(x)) for x in xs])


def _bearings(kpts_px, K):
    """Pixel coords [N,2] -> unit bearing rays [N,3]."""
    ph = np.concatenate([kpts_px, np.ones((len(kpts_px), 1))], axis=1)
    rays = ph @ np.linalg.inv(K).T
    return rays / np.linalg.norm(rays, axis=1, keepdims=True)


def _kabsch_rotation(b0, b1):
    """R minimizing ||b1 - R b0|| over rotations (bearing alignment —
    exact for a pure-rotation revisit)."""
    H = b0.T @ b1
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    return Vt.T @ S @ U.T


def closure_pairs(t: int, min_gap: int) -> list[tuple[int, int]]:
    """The frame pairs (i, j) with j - i >= min_gap, in the order of the
    JAX package's loops (i, then j, ascending)."""
    return [(i, j) for i in range(t) for j in range(i + min_gap, t)]


def match_frame_pairs(descs, valids, pairs, max_distance: float = 5.0):
    """Mutual NN of every frame pair (i, j) of `pairs`, batched
    `mutual_nn_match` calls of MATCH_PAIRS_PER_CALL pairs each (one launch
    of kernel D a call on CUDA): descs [T][K, D], valids [T][K] -> (nn
    [P, K], ok [P, K]) numpy, read back together."""
    d = _stacked(descs)
    v = _stacked(valids).to(d.device).bool()
    k = d.shape[1]
    if not pairs:
        return np.zeros((0, k), np.int64), np.zeros((0, k), bool)
    ij = _to(np.asarray(pairs, np.int64), d.device)
    parts = []
    for ii, jj in zip(ij[:, 0].split(MATCH_PAIRS_PER_CALL),
                      ij[:, 1].split(MATCH_PAIRS_PER_CALL)):
        nn, ok = mutual_nn_match(d[ii], d[jj], v[ii], v[jj], max_distance)
        parts.append(torch.stack([nn, ok.long()]))
    both = torch.cat(parts, dim=1).cpu().numpy()
    return both[0], both[1].astype(bool)


def detect_loop_closures(descs, valids, kpts_px, K, min_gap: int = 3,
                         min_matches: int = 80, max_flow_px: float = 4.0,
                         max_distance: float = 5.0):
    """Scan frame pairs with index gap >= min_gap; emit strong (near-
    coincident) closures as (i, j, R_ji, n_matches). descs [T][K,D] and
    valids [T][K] tensors on one device (or arrays: the CPU), kpts_px
    [T][K,2] pixel coords."""
    kpts_px = [_host(k) for k in kpts_px]
    pairs = closure_pairs(len(kpts_px), min_gap)
    nn, ok = match_frame_pairs(descs, valids, pairs, max_distance)
    closures = []
    for (i, j), nn_p, okn in zip(pairs, nn, ok):
        n = int(okn.sum())
        if n < min_matches:
            continue
        p0 = kpts_px[i][okn]
        p1 = kpts_px[j][nn_p[okn]]
        flow = np.median(np.linalg.norm(p1 - p0, axis=1))
        if flow > max_flow_px:
            continue  # revisit with parallax: scale-ambiguous, skip
        R = _kabsch_rotation(_bearings(p0, K), _bearings(p1, K))
        closures.append((i, j, R, n))
    return closures


def _refine_closure(K, R0, t0, Xi, obs_px, iters=10, huber_px=3.0):
    """Motion-only Gauss-Newton: polish (R, t) of the closure edge by
    minimizing Huber-weighted reprojection of the depth-scaled points Xi
    (frame-i camera coords) into frame j. The essential-matrix direction
    error is the dominant closure noise; reprojection with metric depths
    pins both direction and scale."""
    R0 = R0.copy()
    t0 = t0.copy()
    fxy = np.array([K[0, 0], K[1, 1]])
    for _ in range(iters):
        Xj = Xi @ R0.T + t0
        zj = np.maximum(Xj[:, 2:3], 1e-6)
        proj = Xj[:, :2] / zj * fxy + K[:2, 2]
        r = proj - obs_px                         # [N, 2]
        rn = np.linalg.norm(r, axis=1)
        wgt = np.where(rn <= huber_px, 1.0,
                       np.sqrt(huber_px / np.maximum(rn, 1e-9)))
        # d proj / d Xj
        iz = 1.0 / zj[:, 0]
        Jp = np.zeros((len(Xi), 2, 3))
        Jp[:, 0, 0] = fxy[0] * iz
        Jp[:, 0, 2] = -fxy[0] * Xj[:, 0] * iz * iz
        Jp[:, 1, 1] = fxy[1] * iz
        Jp[:, 1, 2] = -fxy[1] * Xj[:, 1] * iz * iz
        # d Xj / d [omega, dt]: -[R Xi]_x for left-perturbed rotation, I
        RXi = Xi @ R0.T
        Jx = np.zeros((len(Xi), 3, 6))
        Jx[:, 0, 1] = RXi[:, 2]
        Jx[:, 0, 2] = -RXi[:, 1]
        Jx[:, 1, 0] = -RXi[:, 2]
        Jx[:, 1, 2] = RXi[:, 0]
        Jx[:, 2, 0] = RXi[:, 1]
        Jx[:, 2, 1] = -RXi[:, 0]
        Jx[:, :, 3:] = np.eye(3)
        J = np.einsum("nij,njk->nik", Jp, Jx).reshape(-1, 6)
        rw = (r * wgt[:, None]).reshape(-1)
        Jw = J * np.repeat(wgt, 2)[:, None]
        H = Jw.T @ Jw + 1e-6 * np.eye(6)
        g = Jw.T @ rw
        d = np.linalg.solve(H, -g)
        w_ = d[:3]
        th = np.linalg.norm(w_)
        if th > 1e-12:
            k_ = w_ / th
            Kx = np.array([[0, -k_[2], k_[1]], [k_[2], 0, -k_[0]],
                           [-k_[1], k_[0], 0]])
            dR = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
            R0 = dR @ R0
        t0 = t0 + d[3:]
    Xj = Xi @ R0.T + t0
    proj = Xj[:, :2] / np.maximum(Xj[:, 2:3], 1e-6) * fxy + K[:2, 2]
    med = float(np.median(np.linalg.norm(proj - obs_px, axis=1)))
    return R0, t0, med


def _rays_h(px, Kinv):
    """Pixel coords [N, 2] -> homogeneous camera rays (x, y, 1)."""
    ph = np.concatenate([px, np.ones((len(px), 1))], axis=1)
    r = ph @ Kinv.T
    return r / r[:, 2:3]


def _chain_prior(R_rel, t_rel, scales):
    """The odometry chain's world->camera poses (R [T][3,3], t [T][3])."""
    Rs, ts = [np.eye(3)], [np.zeros(3)]
    for k in range(1, len(scales)):
        sk = scales[k] if scales[k] >= 1e-3 else 0.0
        Rs.append(np.asarray(R_rel[k]) @ Rs[-1])
        ts.append(np.asarray(R_rel[k]) @ ts[-1] + sk * np.asarray(t_rel[k]))
    return Rs, ts


def _neighbour_depths(frames, nbs, nb_ok, nbr_px, kpts_px, K, R_rel, t_rel,
                      scales, min_parallax_rad, device):
    """Depth (z, camera-i frame) per keypoint of each frame i of `frames`,
    NaN where unknown, triangulated against its odometry neighbour nbs[i]
    from the neighbour correspondences (nb_ok[i] [K] bool, nbr_px[i]
    [K, 2]); every frame's triangulation in one batched call."""
    Kinv = np.linalg.inv(K)
    out = {i: np.full(len(kpts_px[i]), np.nan) for i in frames}
    tri = [i for i in frames if nb_ok[i].sum() >= 8]
    if not tri:
        return out
    Rs, tvs, u_is, u_ns = [], [], [], []
    for i in tri:
        nb = nbs[i]
        if nb == i + 1:
            R = np.asarray(R_rel[nb])
            tv = float(scales[nb]) * np.asarray(t_rel[nb])
        else:  # pose of (i-1) from i = inverse of (i from i-1)
            R = np.asarray(R_rel[i]).T
            tv = -R @ (float(scales[i]) * np.asarray(t_rel[i]))
        Rs.append(R)
        tvs.append(tv)
        u_is.append(_rays_h(kpts_px[i], Kinv))
        u_ns.append(_rays_h(nbr_px[i], Kinv))

    def f32(x):
        return _to(np.stack(x), device, torch.float32)

    z0, z1 = _triangulate_depths(f32(Rs), f32(tvs), f32(u_is), f32(u_ns))
    z01 = torch.stack([z0, z1]).cpu().numpy()
    for n, i in enumerate(tri):
        okn = nb_ok[i]
        u_i, u_n, R = u_is[n][okn], u_ns[n][okn], Rs[n]
        z0i, z1i = z01[0, n][okn], z01[1, n][okn]
        # triangulation-quality gate on MEASURED parallax: the angle
        # between the rotation-compensated rays. Low-parallax points
        # (the far background) don't triangulate to large z under noise —
        # they triangulate to arbitrary small z, so a depth cut cannot
        # catch them; the ray angle can.
        ui_n = u_i / np.linalg.norm(u_i, axis=1, keepdims=True)
        un_n = u_n / np.linalg.norm(u_n, axis=1, keepdims=True)
        rot_comp = ui_n @ R.T
        cosp = np.clip(np.sum(rot_comp * un_n, axis=1), -1, 1)
        parallax = np.arccos(cosp)
        good = (z0i > 0) & (z1i > 0) & (parallax > min_parallax_rad)
        zz = np.full(int(okn.sum()), np.nan)
        zz[good] = z0i[good]
        out[i][okn] = zz
    return out


def detect_loop_closures_scaled(descs, valids, kpts_px, K, R_rel, t_rel,
                                scales, generator: torch.Generator | None,
                                min_gap: int = 4,
                                min_matches: int = 60,
                                strong_flow_px: float = 4.0,
                                scaled_flow_px: float = 60.0,
                                max_distance: float = 5.0,
                                min_depth_pts: int = 15,
                                n_hyp: int = 1024,
                                reproj_tol_px: float = 5.0,
                                min_parallax_rad: float = 0.04,
                                prior_gate_abs: float = 0.3,
                                prior_gate_per_edge: float = 0.06,
                                prior_rot_gate: float = 0.35,
                                images=None, draw_samples=None,
                                angles=None):
    """Loop closures including parallax revisits (metric translation).

    Near-coincident revisits get the zero-translation Kabsch edge (as
    detect_loop_closures). Revisits with real parallax additionally recover
    a *metric* closure: essential RANSAC gives (R_ji, unit t); the scale
    comes from the odometry map — frame i's matched keypoints are
    triangulated against its odometry neighbour (known scaled relative
    pose), and each depth votes for the closure scale via the epipolar
    transfer equation u_j x (R z u_i + s t) = 0. The median positive vote
    wins; closures with too few depth votes or >50% MAD spread are
    rejected.

    Returns list of (i, j, R_ji, t_ji [3], n_matches); t_ji is zeros for
    strong closures. Conventions match optimize_with_closures:
    X_j = R X_i + t.

    `images` (optional, [T] of [H,W,C] float arrays or tensors): when
    given, the neighbour correspondences that anchor the map depths come
    from pyramidal LK tracking instead of descriptor matching — local
    tracking is immune to the repeated-structure descriptor aliasing that
    poisons wide-baseline matching.

    Randomness: RANSAC's minimal samples are `draw_samples(masks)` (masks
    [C, K] bool of the C parallax candidates, in pair order -> [C, n_hyp,
    8] indices), by default drawn from `generator`; the LK start jitter's
    angles are `angles` [T, K] (frame i's tracks take row i), by default
    drawn from `generator`. The generator lives on the descriptors'
    device.
    """
    kpts_px = [_host(k) for k in kpts_px]
    K = np.asarray(K)
    t = len(kpts_px)
    dev = _stacked(descs).device
    pairs = closure_pairs(t, min_gap)
    nbs = [i + 1 if i + 1 < t else i - 1 for i in range(t)]
    # without images, every frame's neighbour matches ride in the same call
    nb_pairs = [(i, nbs[i]) for i in range(t)] if images is None else []
    nn_all, ok_all = match_frame_pairs(descs, valids, pairs + nb_pairs,
                                       max_distance)
    fx = float(K[0, 0])
    fxy = np.array([K[0, 0], K[1, 1]])

    # odometry-chain prior for drift-envelope (chi^2-style) gating: a
    # closure measurement must land within the drift envelope of the chain
    # prediction, which widens with the edge gap — a repeated-structure
    # scene can produce coherent-but-wrong match sets that survive every
    # image-space check, but they claim relative poses far outside any
    # plausible accumulated drift
    Rs_chain, ts_chain = _chain_prior(R_rel, t_rel, scales)

    def prior_rel(ii, jj):
        R_p = Rs_chain[jj] @ Rs_chain[ii].T
        t_p = ts_chain[jj] - R_p @ ts_chain[ii]
        return R_p, t_p

    found = {}          # pair index -> closure, emitted in pair order
    cands = []
    for p, (i, j) in enumerate(pairs):
        okn = ok_all[p]
        n = int(okn.sum())
        if n < min_matches:
            continue
        nn = nn_all[p]
        p0 = kpts_px[i][okn]
        p1 = kpts_px[j][nn[okn]]
        flow = np.median(np.linalg.norm(p1 - p0, axis=1))
        if flow <= strong_flow_px:
            R = _kabsch_rotation(_bearings(p0, K), _bearings(p1, K))
            found[p] = (i, j, R, np.zeros(3), n)
            continue
        if flow > scaled_flow_px:
            # not a revisit, just far-away covisibility: the closure scale
            # rests on map depths whose bias is invisible to the
            # (scale-invariant) reprojection check — skip
            continue
        cands.append(p)
    if not cands:
        return [found[p] for p in sorted(found)]

    # parallax revisits: metric closures from E + map depths, RANSAC-E and
    # recoverPose over all candidates at once, read back together
    def f32(x):
        return _to(np.stack(x), dev, torch.float32)

    p0n = f32([(kpts_px[pairs[p][0]] - K[:2, 2]) / fxy for p in cands])
    p1n = f32([(kpts_px[pairs[p][1]][nn_all[p]] - K[:2, 2]) / fxy
               for p in cands])
    masks = _to(ok_all[cands], dev)
    idx = (draw_samples(masks) if draw_samples is not None
           else _sample_minimal(masks, n_hyp, 8, generator))
    E, inl, ok_e = ransac_essential_from_samples(p0n, p1n, masks,
                                                 _to(idx, dev),
                                                 thresh=2.0 / fx)
    R_c, t_c, pmask, _ = recover_pose(E, p0n, p1n, inl)
    c, k = masks.shape
    packed = torch.cat([inl.float(), pmask.float(), ok_e.float()[:, None],
                        R_c.reshape(c, 9), t_c], dim=1).cpu().numpy()
    inl_h, pm_h = packed[:, :k] > 0, packed[:, k:2 * k] > 0
    ok_h = packed[:, 2 * k] > 0
    R_h = packed[:, 2 * k + 1:2 * k + 10].reshape(c, 3, 3)
    t_h = packed[:, 2 * k + 10:]
    # an honest closure keeps most of its matches on the epipolar geometry;
    # a low ratio means RANSAC fit a contaminated set
    keep = [n for n, p in enumerate(cands)
            if ok_h[n] and int(inl_h[n].sum()) >= 0.6 * int(ok_all[p].sum())]

    # the map depths of every frame that a kept candidate starts from
    frames = sorted({pairs[cands[n]][0] for n in keep})
    frames = [i for i in frames
              if (scales[nbs[i]] if nbs[i] == i + 1 else scales[i]) >= 1e-3]
    nb_ok, nbr_px = {}, {}
    if images is not None and frames:
        sel = frames + [nbs[i] for i in frames]
        if isinstance(images[0], torch.Tensor):
            imgs = torch.stack([images[i].to(dev, torch.float32)
                                for i in sel])
        else:
            imgs = _to(np.stack([np.asarray(images[i], np.float32)
                                 for i in sel]), dev)
        h_im, w_im = imgs.shape[1:3]
        sc = np.array([w_im - 1.0, h_im - 1.0])
        pts01 = f32([kpts_px[i] / sc for i in frames])
        if angles is None:
            angles = draw_angles((t, pts01.shape[1]), generator, dev)
        tracked, lk_err = optical_flow_batch_from_angles(
            imgs[:len(frames)], imgs[len(frames):], pts01, pts01,
            _to(angles, dev)[frames], NEIGHBOUR_LK)
        tr_err = torch.cat([tracked, lk_err[..., None]], -1).cpu().numpy()
        for n, i in enumerate(frames):
            nb_ok[i] = tr_err[n, :, 2] < 4.0
            nbr_px[i] = tr_err[n, :, :2] * sc
    else:
        for i in frames:
            nb_ok[i] = ok_all[len(pairs) + i]
            nbr_px[i] = kpts_px[nbs[i]][nn_all[len(pairs) + i]]
    depths = _neighbour_depths(frames, nbs, nb_ok, nbr_px, kpts_px, K, R_rel,
                               t_rel, scales, min_parallax_rad, dev)

    Kinv = np.linalg.inv(K)
    for n in keep:
        p = cands[n]
        i, j = pairs[p]
        nn = nn_all[p]
        R, tj, pm = R_h[n], t_h[n], pm_h[n]
        z = depths.get(i, np.full(len(kpts_px[i]), np.nan))
        sel = pm & np.isfinite(z)
        if int(sel.sum()) < min_depth_pts:
            continue
        u_i = _rays_h(kpts_px[i][sel], Kinv)
        u_j = _rays_h(kpts_px[j][nn[sel]], Kinv)
        # u_j x (R (z u_i) + s t) = 0  ->  s per point by least squares
        a = np.cross(u_j, np.broadcast_to(tj, u_j.shape))
        b = np.cross(u_j, (z[sel, None] * u_i) @ R.T)
        denom = np.sum(a * a, axis=1)
        s_votes = -np.sum(a * b, axis=1) / np.maximum(denom, 1e-12)
        s_votes = s_votes[(s_votes > 1e-3) & np.isfinite(s_votes)
                          & (denom > 1e-8)]
        if len(s_votes) < min_depth_pts:
            continue
        s = float(np.median(s_votes))
        mad = float(np.median(np.abs(s_votes - s)))
        if mad > 0.5 * s:
            continue  # inconsistent depth votes
        # polish (R, t) against the metric points. Seeding matters: the
        # E-based pose sits near the translation-rotation ambiguity valley
        # (narrow FOV, small baseline) and GN from it can collapse t -> 0;
        # the odometry prior is within drift of the truth, i.e. in the
        # right basin.
        R_p, t_p = prior_rel(i, j)
        Xi = z[sel, None] * u_i
        Rr, tr, med_px = _refine_closure(K, R_p, t_p, Xi,
                                         kpts_px[j][nn[sel]])
        if med_px > reproj_tol_px:
            continue
        gate = prior_gate_abs + prior_gate_per_edge * (j - i)
        cosr = np.clip((np.trace(Rr.T @ R_p) - 1) / 2, -1, 1)
        if np.linalg.norm(tr - t_p) > gate or \
                np.arccos(cosr) > prior_rot_gate + 0.03 * (j - i):
            continue  # outside the drift envelope of the odometry prior
        found[p] = (i, j, Rr, tr, int(ok_all[p].sum()))
    return [found[p] for p in sorted(found)]


def closure_graph(R_rel, t_rel, scales, closures,
                  closure_weight: float = 3.0,
                  scaled_closure_weight: float = 1.0,
                  device: str | torch.device = "cuda") -> PoseGraph:
    """The pose graph of the odometry chain plus the closure edges, float32
    on `device` (the graph `optimize_with_closures` solves)."""
    t = len(scales)
    Rs, ts = _chain_prior(R_rel, t_rel, scales)
    ei, ej, mR, mt, w = [], [], [], [], []
    for i in range(1, t):
        ei.append(i - 1)
        ej.append(i)
        mR.append(R_rel[i])
        mt.append(scales[i] * t_rel[i])
        w.append(1.0)
    for cl in closures:
        if len(cl) == 4:        # strong closure (i, j, R, n)
            i, j, R, _n = cl
            tv = np.zeros(3)
        else:                   # scaled closure (i, j, R, t, n)
            i, j, R, tv, _n = cl
        ei.append(i)
        ej.append(j)
        mR.append(R)
        mt.append(np.asarray(tv, np.float64))
        # near-coincident (zero-translation) closures are nearly exact;
        # scaled parallax closures carry E-direction + map-depth noise and
        # get a weight on par with an odometry edge
        strong = float(np.linalg.norm(np.asarray(tv))) < 1e-9
        w.append(closure_weight if strong else scaled_closure_weight)
    dev = resolve_device(device)

    def f32(x):
        return _to(np.stack(x), dev, torch.float32)

    return PoseGraph(
        R=f32(Rs), t=f32(ts), edge_i=_to(np.asarray(ei), dev, torch.long),
        edge_j=_to(np.asarray(ej), dev, torch.long), meas_R=f32(mR),
        meas_t=f32(mt), weight=_to(np.asarray(w), dev, torch.float32))


def optimize_with_closures(R_rel, t_rel, scales, closures, iters: int = 15,
                           closure_weight: float = 3.0,
                           scaled_closure_weight: float = 1.0,
                           device: str | torch.device = "cuda"):
    """Pose graph from the odometry chain plus the closure edges, solved on
    `device`; returns optimized cam-from-world (R_w2c [T,3,3], t_w2c [T,3]
    numpy, final residual)."""
    g = closure_graph(R_rel, t_rel, scales, closures, closure_weight,
                      scaled_closure_weight, device)
    Rf, tf, res = pgo_solve(g, iters=iters, damping=1e-4)
    return Rf.cpu().numpy(), tf.cpu().numpy(), float(res)
