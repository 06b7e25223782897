"""Plain warps, repeatability, RANSAC-H, 8-point RANSAC-E, recoverPose and
the pose error, batched over pairs; float32 except where noted float64.

RANSAC's minimal samples are a Gumbel top-k over the valid matches, from
uniform draws [n_hyp, K] of a torch.Generator seeded with the pair's seed
on the pair's device. On CUDA three solves run in float64, as the
measured program's do (cuSOLVER's batched float32 SVD loses the smallest
singular vector of these raw-coordinate systems): the homography DLT's
SVD, RANSAC-E's hypotheses (the 8 x 8 minors of each sample's design, a
sample of rank < 8 counting no inliers) and its refits.
"""
from __future__ import annotations

import math

import torch

# --- warps and repeatability ------------------------------------------------


def warp_homography(kpts, valid, H, width: float, height: float):
    """kpts [B,K,>=2] normalised (x, y) -> (p [B,K,2], warped [B,K,2],
    valid & inside [B,K]), normalised by (w - 1, h - 1)."""
    scale = torch.tensor([width - 1.0, height - 1.0], device=kpts.device)
    p = kpts[..., 0:2] * scale
    ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
    q = ph @ H.transpose(-1, -2)
    qz = q[..., 2:3]
    q = q[..., 0:2] / torch.where(qz.abs() > 1e-12, qz,
                                  torch.full_like(qz, 1e-12))
    inb = ((q[..., 0] >= 0) & (q[..., 0] <= scale[0])
           & (q[..., 1] >= 0) & (q[..., 1] <= scale[1]))
    return p / scale, q / scale, valid & inb


def _dist(a, b):
    d = a[..., :, None, :] - b[..., None, :, :]
    return torch.sqrt((d * d).sum(-1) + 1e-24)


def repeatability(v0, v1, a0, a01, va, b0, b10, vb, scale, th: float):
    """Per pair (repeatability, mean_error, num_feat, gt_num) of keypoints
    a0 warped to a01 (valid va) and b0 warped to b10 (valid vb): mutual
    minima of the symmetric distance matrix over the covisible keypoints,
    the first min(M, N) diagonal entries of the compacted matrix set to
    99999 (the reference protocol's quirk), hits within th px."""
    num_feat = torch.minimum(v0.sum(-1), v1.sum(-1))
    ok = va[..., :, None] & vb[..., None, :]
    dm = (_dist(a0, b10) + _dist(b0, a01).transpose(-1, -2)) / 2.0
    r0 = torch.cumsum(va.int(), -1) - 1
    r1 = torch.cumsum(vb.int(), -1) - 1
    diag = (r0[..., :, None] == r1[..., None, :]) & ok
    dm = torch.where(diag, torch.full_like(dm, 99999.0), dm)
    dm = torch.where(ok, dm, torch.full_like(dm, 1e9))
    mutual = ((dm == dm.min(-1, keepdim=True).values)
              & (dm == dm.min(-2, keepdim=True).values) & ok)
    ds = dm * scale[:, None, None]
    hit = mutual & (ds <= th)
    gt = hit.sum((-2, -1))
    err = torch.where(hit, ds, torch.zeros_like(ds)).sum((-2, -1))
    mean_err = torch.where(gt > 0, err / gt, torch.full_like(err, math.nan))
    rep = torch.where(num_feat > 0, gt / num_feat.clamp_min(1),
                      torch.zeros_like(err))
    empty = (va.sum(-1) == 0) | (vb.sum(-1) == 0)
    rep = torch.where(empty, torch.zeros_like(rep), rep)
    num_feat = torch.where(empty, torch.zeros_like(num_feat), num_feat)
    return rep, mean_err, num_feat, gt

# --- RANSAC ------------------------------------------------------------------


def minimal_samples(mask, seeds, n_hyp: int, size: int):
    """[B, n_hyp, size] distinct valid indices per pair: pair j's Gumbel
    top-k from torch.rand((n_hyp, K)) of a generator seeded seeds[j]."""
    u = []
    for s in seeds:
        g = torch.Generator(device=mask.device).manual_seed(int(s))
        u.append(torch.rand((n_hyp, mask.shape[-1]), generator=g,
                            device=mask.device))
    cur = -torch.log(-torch.log(torch.stack(u)))
    cur = torch.where(mask[:, None, :], cur, torch.full_like(cur, -math.inf))
    cols = torch.arange(mask.shape[-1], device=mask.device)
    idx = []
    for _ in range(size):
        am = cur.argmax(-1)
        idx.append(am)
        cur = torch.where(cols == am[..., None],
                          torch.full_like(cur, -math.inf), cur)
    return torch.stack(idx, -1)


def _take(p, idx):
    """p [B,K,2], idx [B,n,s] -> [B,n,s,2]."""
    flat = idx.flatten(-2)
    out = p.gather(1, flat[..., None].expand(*flat.shape, p.shape[-1]))
    return out.unflatten(1, idx.shape[1:])


def _pick(x, i):
    """x [B, n, ...], i [B] -> x[b, i[b]]."""
    return x[torch.arange(x.shape[0], device=x.device), i]


def _dlt_h(p0, p1, w):
    """Weighted homography DLT: the right singular vector of A^T A's
    smallest singular value (float64 SVD on CUDA)."""
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    a = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    ata = a.transpose(-1, -2) @ a
    if ata.is_cuda:
        vh = torch.linalg.svd(ata.double())[2].float()
    else:
        vh = torch.linalg.svd(ata)[2]
    return vh[..., -1, :].unflatten(-1, (3, 3))


def _hartley(p, w):
    """Similarity taking the weighted centroid to 0, mean distance sqrt 2."""
    wsum = w.sum(-1).clamp_min(1e-9)
    c = (p * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((p - c[..., None, :]) ** 2).sum(-1) + 1e-18)
    s = math.sqrt(2.0) / ((d * w).sum(-1) / wsum).clamp_min(1e-9)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([torch.stack([s, z, -s * c[..., 0]], -1),
                        torch.stack([z, s, -s * c[..., 1]], -1),
                        torch.stack([z, z, o], -1)], -2)


def _apply(T, p):
    sc = torch.stack([T[..., 0, 0], T[..., 1, 1]], -1)[..., None, :]
    sh = torch.stack([T[..., 0, 2], T[..., 1, 2]], -1)[..., None, :]
    return p * sc + sh


def _h_residual(H, p0, p1):
    ph = torch.cat([p0, torch.ones_like(p0[..., :1])], -1)
    q = ph @ H.transpose(-1, -2)
    qz = q[..., 2:3]
    qz = torch.where(qz.abs() > 1e-12, qz, torch.full_like(qz, 1e-12))
    return torch.linalg.vector_norm(q[..., 0:2] / qz - p1, dim=-1)


def ransac_h_inliers(p0, p1, mask, idx, thresh: float = 3.0):
    """RANSAC-H over the samples idx [B,n,4] on pixel matches -> (inliers
    of the refit homography, 0 where it failed) [B]. The best hypothesis
    (first on ties) is refit on its inliers, Hartley-normalised."""
    hs = _dlt_h(_take(p0, idx), _take(p1, idx),
                torch.ones(idx.shape, device=p0.device))
    res = _h_residual(hs, p0[:, None], p1[:, None])
    inl = (res < thresh) & mask[:, None, :]
    counts = inl.sum(-1)
    best = counts.argmax(-1)
    w = _pick(inl, best).float()
    t0, t1 = _hartley(p0, w), _hartley(p1, w)
    hn = _dlt_h(_apply(t0, p0), _apply(t1, p1), w)
    H = torch.linalg.inv_ex(t1)[0] @ (hn @ t0)
    h22 = H[..., 2:3, 2:3]
    H = H / torch.where(h22.abs() > 1e-12, h22, torch.full_like(h22, 1e-12))
    final = (_h_residual(H, p0, p1) < thresh) & mask
    ok = (mask.sum(-1) >= 4) & (_pick(counts, best) >= 4)
    return torch.where(ok, final.sum(-1), 0).float()


def _design8(p0, p1):
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                        torch.ones_like(x0)], -1)


def _eightpoint(p0, p1, w):
    a = _design8(p0, p1) * w[..., None]
    return torch.linalg.svd(a.transpose(-1, -2) @ a)[2][..., -1, :] \
        .unflatten(-1, (3, 3))


_MINORS = [[c for c in range(9) if c != k] for k in range(9)]


def _hypotheses_e(q0, q1):
    """Null vectors of the 8 x 9 sample designs -> (E [..., 3, 3], valid).
    CUDA: float64 signed minors (Cramer), a sample whose minors' norm is
    under 1e-13 of its rows' norms' product being of rank < 8 (invalid).
    CPU: float32 SVD, every sample valid."""
    if not q0.is_cuda:
        e = _eightpoint(q0, q1, torch.ones_like(q0[..., 0]))
        return e, torch.ones(e.shape[:-2], dtype=torch.bool, device=e.device)
    a = _design8(q0.double(), q1.double())
    minors = torch.linalg.det(a[..., _MINORS].transpose(-3, -2))
    v = minors * torch.tensor([1.0, -1.0] * 4 + [1.0], dtype=a.dtype,
                              device=a.device)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    vol = torch.linalg.vector_norm(a, dim=-1).prod(-1)
    valid = (n[..., 0] > 1e-13 * vol) & torch.isfinite(n[..., 0])
    v = torch.where(valid[..., None], v / n.clamp_min(1e-300),
                    torch.zeros_like(v))
    return v.float().unflatten(-1, (3, 3)), valid


def _refit_e(p0, p1, w):
    if p0.is_cuda:
        return _eightpoint(p0.double(), p1.double(), w.double()).float()
    return _eightpoint(p0, p1, w)


def _essential(E):
    """Singular values (m, m, 0), m the mean of the largest two."""
    u, s, vh = torch.linalg.svd(E)
    m = (s[..., 0] + s[..., 1]) / 2.0
    return (u * torch.stack([m, m, torch.zeros_like(m)], -1)[..., None, :]) \
        @ vh


def _sampson(F, p0, p1):
    ph0 = torch.cat([p0, torch.ones_like(p0[..., :1])], -1)
    ph1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    fx0 = ph0 @ F.transpose(-1, -2)
    ftx1 = ph1 @ F
    num = (ph1 * fx0).sum(-1)
    den = (fx0[..., 0] ** 2 + fx0[..., 1] ** 2 + ftx1[..., 0] ** 2
           + ftx1[..., 1] ** 2)
    return num.abs() / torch.sqrt(den.clamp_min(1e-18))


def ransac_e(p0n, p1n, mask, idx, thresh):
    """8-point RANSAC-E on normalised coordinates over the samples idx
    [B,n,8]; thresh [B] Sampson. The winner (most inliers, first on ties)
    is refit three times on its inliers -> (E, inliers [B,K], ok [B])."""
    e9, valid = _hypotheses_e(_take(p0n, idx), _take(p1n, idx))
    res = _sampson(_essential(e9), p0n[:, None], p1n[:, None])
    inl = (res < thresh[:, None, None]) & mask[:, None, :] & valid[..., None]
    counts = inl.sum(-1)
    best = counts.argmax(-1)
    w = _pick(inl, best).float()
    for _ in range(3):
        E = _essential(_refit_e(p0n, p1n, w))
        w = ((_sampson(E, p0n, p1n) < thresh[:, None]) & mask).float()
    ok = (mask.sum(-1) >= 8) & (_pick(counts, best) >= 8)
    return E, w > 0, ok


def recover_pose(E, p0n, p1n, mask):
    """Of E's four poses, the one with most masked points in front of both
    cameras (first on ties) -> (R [B,3,3], t [B,3], count [B])."""
    u, _, vh = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vh = vh * torch.sign(torch.linalg.det(vh))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1, R2, t = u @ (W @ vh), u @ (W.T @ vh), u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], 1)                  # [B,4,3,3]
    ts = torch.stack([t, -t, t, -t], 1)                    # [B,4,3]
    u0 = torch.cat([p0n, torch.ones_like(p0n[..., :1])], -1)[:, None]
    u1 = torch.cat([p1n, torch.ones_like(p1n[..., :1])], -1)[:, None]
    ru0 = u0 @ Rs.transpose(-1, -2)
    a = torch.linalg.cross(ru0, u1, dim=-1)
    b = -torch.linalg.cross(ts[:, :, None, :], u1, dim=-1)
    z0 = (a * b).sum(-1) / (a * a).sum(-1).clamp_min(1e-18)
    z1 = (z0[..., None] * ru0 + ts[:, :, None, :])[..., 2]
    goods = (z0 > 0) & (z1 > 0) & mask[:, None, :]
    counts = goods.sum(-1)
    best = counts.argmax(-1)
    return _pick(Rs, best), _pick(ts, best), _pick(counts, best)


def pose_error(R, t, T01):
    """max(angle of t, with its sign ambiguity; angle of R) in degrees."""
    R_gt, t_gt = T01[:, :3, :3], T01[:, :3, 3]
    n = torch.linalg.vector_norm(t, dim=-1) * torch.linalg.vector_norm(
        t_gt, dim=-1)
    cos_t = ((t * t_gt).sum(-1) / n.clamp_min(1e-12)).clamp(-1.0, 1.0)
    err_t = torch.rad2deg(torch.arccos(cos_t))
    err_t = torch.minimum(err_t, 180.0 - err_t)
    tr = torch.diagonal(R.transpose(-1, -2) @ R_gt, dim1=-2, dim2=-1).sum(-1)
    err_r = torch.rad2deg(torch.arccos(((tr - 1) / 2.0).clamp(-1.0, 1.0)))
    return torch.maximum(err_t, err_r.abs())


def relative_pose(p0, p1, ok, K0, K1, seeds, n_hyp: int):
    """Pixel matches -> (R, t, inliers in front [B], ok [B]): coordinates
    normalised by the intrinsics, Sampson threshold 1 px / f_mean, 8-point
    RANSAC-E over seeded samples, recoverPose on its inliers."""
    f_mean = (K0[:, 0, 0] + K1[:, 1, 1] + K0[:, 0, 0] + K1[:, 1, 1]) / 4.0

    def norm(p, K):
        c = torch.stack([K[:, 0, 2], K[:, 1, 2]], -1)[:, None]
        f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None]
        return (p - c) / f

    p0n, p1n = norm(p0, K0), norm(p1, K1)
    E, inl, ok_e = ransac_e(p0n, p1n, ok, minimal_samples(ok, seeds, n_hyp,
                                                          8), 1.0 / f_mean)
    R, t, n_in = recover_pose(E, p0n, p1n, inl)
    return R, t, n_in, ok_e & (ok.sum(-1) >= 5)


def pose_auc(errors, thresholds=(5.0, 10.0, 20.0)) -> list:
    """Trapezoid AUC of the error-recall curve at each threshold."""
    import numpy as np
    errors = np.sort(np.asarray(errors, np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    out = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.r_[recall[:last], recall[last - 1]]
        e = np.r_[errors[:last], t]
        out.append(float(((e[1:] - e[:-1]) * (r[1:] + r[:-1]) / 2.0).sum())
                   / t)
    return out
