"""Fixed-hypothesis RANSAC for homographies, fundamental and essential
matrices, and recoverPose (counterpart of keypoint_bench_tpu/geometry/
ransac.py, on the exact path that the JAX package takes on the CPU:
stacked DLT rows, the SVD of A^T A, the SVD rank-2 and essential
projections, the SVD decomposition of E).

A static batch of minimal samples (Gumbel top-k over the validity mask,
drawn from an explicit torch.Generator), one batched SVD for every
hypothesis, one [n_hyp, K] residual matrix, the best hypothesis by inlier
count, then a Hartley-normalized weighted refit on its inliers. Every
function takes leading batch dimensions. The JAX package's TPU-only
list-form, fixed-iteration and deflation solves (`_essential_project_fast`,
`essential_basis`, `svd3`) are not ported: they are numerics workarounds
for the TPU, not semantics. On CUDA the raw-coordinate solves of RANSAC-H
and RANSAC-E run in float64 instead (`_solve_dlt_h`, `_solve_minimal_e`,
`_solve_eightpoint_e`), where cuSOLVER's batched float32 SVD parts from
LAPACK's.
"""
from __future__ import annotations

import math

import torch

from keypoint_bench_tpu_torch.utils import profiling


def _sample_minimal(mask: torch.Tensor, n_hyp: int, sample_size: int,
                    generator: torch.Generator) -> torch.Tensor:
    """[..., n_hyp, sample_size] distinct indices of valid entries of mask
    [..., K] (Gumbel top-k by argmax peeling). With fewer than sample_size
    valid entries the result repeats indices; callers gate on the count."""
    u = torch.rand((*mask.shape[:-1], n_hyp, mask.shape[-1]),
                   generator=generator, device=mask.device)
    return peel_samples(mask, u, sample_size)


def peel_samples(mask: torch.Tensor, u: torch.Tensor,
                 sample_size: int) -> torch.Tensor:
    """`_sample_minimal` from given uniform draws u [..., n_hyp, K]."""
    k = mask.shape[-1]
    g = -torch.log(-torch.log(u))
    cur = torch.where(mask[..., None, :], g, torch.full_like(g, -math.inf))
    cols = torch.arange(k, device=mask.device)
    idxs = []
    for _ in range(sample_size):
        am = cur.argmax(-1)
        idxs.append(am)
        cur = torch.where(cols == am[..., None], torch.full_like(cur,
                                                                 -math.inf),
                          cur)
    return torch.stack(idxs, dim=-1)


def _solve_dlt_h(p0: torch.Tensor, p1: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Weighted homography DLT: p0, p1 [..., N, 2], w [..., N] -> H
    [..., 3, 3] mapping p0 to p1, the right singular vector of the
    smallest singular value of A^T A for the weighted [2N, 9] design A.

    The hypotheses solve raw pixel coordinates, as the reference does, so
    A^T A spans 1 to ~1e11 at 800 px. LAPACK's float32 SVD (the CPU, and
    the JAX package on the CPU) keeps its smallest singular vector;
    cuSOLVER's batched float32 SVD loses it (no hypothesis with a second
    inlier on most HPatches-sized pairs), so on CUDA the SVD runs in
    float64 on the float32 A^T A, and H comes back in float32."""
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    a = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    ata = a.transpose(-1, -2) @ a
    if ata.is_cuda:
        vh = torch.linalg.svd(ata.double())[2].to(ata.dtype)
    else:
        vh = torch.linalg.svd(ata)[2]
    return vh[..., -1, :].unflatten(-1, (3, 3))


def _normalize_pts(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalization over weighted points: the similarity T [..., 3,
    3] taking the weighted centroid to 0 and the mean distance to sqrt(2)."""
    wsum = torch.clamp_min(w.sum(-1), 1e-9)
    c = (p * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((p - c[..., None, :]) ** 2).sum(-1) + 1e-18)
    md = (d * w).sum(-1) / wsum
    s = math.sqrt(2.0) / torch.clamp_min(md, 1e-9)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * c[..., 0]], dim=-1),
        torch.stack([zero, s, -s * c[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def _apply_T(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    scale = torch.stack([T[..., 0, 0], T[..., 1, 1]], dim=-1)
    shift = torch.stack([T[..., 0, 2], T[..., 1, 2]], dim=-1)
    return p * scale[..., None, :] + shift[..., None, :]


def _homography_residual(H: torch.Tensor, p0: torch.Tensor,
                         p1: torch.Tensor) -> torch.Tensor:
    """Forward reprojection error |p1 - H p0| (cv2.findHomography's
    measure): H [..., 3, 3], p0/p1 [..., N, 2] -> [..., N]."""
    ph = torch.cat([p0, torch.ones_like(p0[..., :1])], dim=-1)
    q = ph @ H.transpose(-1, -2)
    qz = q[..., 2:3]
    qz = torch.where(qz.abs() > 1e-12, qz, torch.full_like(qz, 1e-12))
    return torch.linalg.vector_norm(q[..., 0:2] / qz - p1, dim=-1)


def _take(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p [..., K, 2], idx [..., n, s] -> [..., n, s, 2]."""
    flat = idx.flatten(-2).long()
    out = p.gather(-2, flat[..., None].expand(*flat.shape, p.shape[-1]))
    return out.unflatten(-2, idx.shape[-2:])


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., n, *rest], idx [...] -> x[..., idx, *rest]."""
    d = idx.dim()
    i = idx.reshape(*idx.shape, 1, *([1] * (x.dim() - d - 1)))
    return x.gather(d, i.expand(*idx.shape, 1, *x.shape[d + 1:])).squeeze(d)


def ransac_homography_from_samples(p0: torch.Tensor, p1: torch.Tensor,
                                   mask: torch.Tensor, idx: torch.Tensor,
                                   thresh: float = 3.0):
    """RANSAC over given minimal samples idx [..., n_hyp, 4]; p0, p1
    [..., K, 2] pixel coordinates, mask [..., K]. Returns (H [..., 3, 3]
    with H[2, 2] = 1, inliers [..., K], ok [...])."""
    with profiling.span("kbt.geometry.ransac.solve"):
        q0, q1 = _take(p0, idx), _take(p1, idx)
        hs = _solve_dlt_h(q0, q1, torch.ones_like(q0[..., 0]))
    with profiling.span("kbt.geometry.ransac.score"):
        res = _homography_residual(hs, p0[..., None, :, :],
                                   p1[..., None, :, :])
        inl = (res < thresh) & mask[..., None, :]
        counts = inl.sum(-1)
        best = counts.argmax(-1)
    with profiling.span("kbt.geometry.ransac.refit"):
        w = _rows(inl, best).float()
        t0 = _normalize_pts(p0, w)
        t1 = _normalize_pts(p1, w)
        hn = _solve_dlt_h(_apply_T(t0, p0), _apply_T(t1, p1), w)
        H = torch.linalg.inv_ex(t1)[0] @ (hn @ t0)
        h22 = H[..., 2:3, 2:3]
        H = H / torch.where(h22.abs() > 1e-12, h22,
                            torch.full_like(h22, 1e-12))
        final = (_homography_residual(H, p0, p1) < thresh) & mask
        ok = (mask.sum(-1) >= 4) & (_rows(counts, best) >= 4)
    return H, final, ok


def ransac_homography(p0: torch.Tensor, p1: torch.Tensor, mask: torch.Tensor,
                      generator: torch.Generator, n_hyp: int = 512,
                      thresh: float = 3.0):
    """p0, p1 [..., K, 2] pixel coordinates, mask [..., K]; minimal samples
    drawn from `generator` (on the tensors' device). Returns (H [..., 3, 3],
    inliers [..., K], ok [...])."""
    idx = _sample_minimal(mask, n_hyp, 4, generator)
    return ransac_homography_from_samples(p0, p1, mask, idx, thresh)


def _eightpoint_design(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """The 8-point design rows of x1^T F x0 = 0: p0, p1 [..., N, 2] ->
    [..., N, 9]."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    o = torch.ones_like(x0)
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                        o], dim=-1)


def _solve_eightpoint(p0: torch.Tensor, p1: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point DLT for x1^T F x0 = 0: p0, p1 [..., N, 2], w
    [..., N] -> [..., 3, 3], the right singular vector of the smallest
    singular value of A^T A; not rank-reduced."""
    a = _eightpoint_design(p0, p1) * w[..., None]
    _, _, vh = torch.linalg.svd(a.transpose(-1, -2) @ a)
    return vh[..., -1, :].unflatten(-1, (3, 3))


# column k of the 8 x 9 design left out, for its k-th minor
_MINOR_COLS = [[c for c in range(9) if c != k] for k in range(9)]


def _nullvec_minors(a: torch.Tensor):
    """The null vector of 8 x 9 designs a [..., 8, 9] by Cramer's rule: the
    signed 8 x 8 minors, unit-normalized -> (v [..., 9], valid [...]).
    The minors' norm is the rows' 8-volume, at most the product of the row
    norms; where it falls under 1e-13 of that product, a has rank < 8 to
    rounding, and the row is invalid (v is then 0)."""
    minors = torch.linalg.det(a[..., _MINOR_COLS].transpose(-3, -2))
    sign = torch.tensor([1.0, -1.0] * 4 + [1.0], dtype=a.dtype,
                        device=a.device)
    v = minors * sign
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    volume = torch.linalg.vector_norm(a, dim=-1).prod(-1)
    valid = (n[..., 0] > 1e-13 * volume) & torch.isfinite(n[..., 0])
    return torch.where(valid[..., None], v / n.clamp_min(1e-300),
                       torch.zeros_like(v)), valid


def _solve_minimal_e(q0: torch.Tensor, q1: torch.Tensor):
    """RANSAC-E's hypotheses from minimal samples q0, q1 [..., n_hyp, 8, 2]
    of raw normalized camera coordinates -> (E [..., n_hyp, 3, 3] not
    projected, valid [..., n_hyp]).

    Their A^T A is ill-conditioned, and cuSOLVER's batched float32 SVD of
    it picks, on noisy matches, winners that hold a third of their
    inliers under a float64 solve (`chip_smoke.py` phase 47 compares the
    routes). So on CUDA the design's null vector comes from its minors in
    float64 (`_nullvec_minors`; a sample of rank < 8 is invalid and counts
    no inliers; at [8, 4096] on an H100 under a tenth of the float32 SVD's
    time), E in the inputs' dtype. The CPU keeps the JAX package's
    float32 SVD (every sample valid)."""
    if not q0.is_cuda:
        e = _solve_eightpoint(q0, q1, torch.ones_like(q0[..., 0]))
        return e, torch.ones(e.shape[:-2], dtype=torch.bool,
                             device=e.device)
    v, valid = _nullvec_minors(_eightpoint_design(q0.double(),
                                                  q1.double()))
    return v.to(q0.dtype).unflatten(-1, (3, 3)), valid


def _solve_eightpoint_e(p0: torch.Tensor, p1: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """`_solve_eightpoint` as RANSAC-E's refits run it, on raw normalized
    camera coordinates. On a noisy match set their A^T A is ill-conditioned:
    in float32 the card's and the CPU's refits from one hypothesis can end
    hundreds of inliers apart where their float64 refits agree
    (`chip_smoke.py` phase 47). So on CUDA the design, A^T A and the SVD
    are float64, and the solution comes back in the inputs' dtype; the CPU
    keeps the JAX package's float32 path."""
    if p0.is_cuda:
        return _solve_eightpoint(p0.double(), p1.double(),
                                 w.double()).to(p0.dtype)
    return _solve_eightpoint(p0, p1, w)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """The nearest rank-2 matrix: the smallest singular value set to 0."""
    u, s, vh = torch.linalg.svd(F)
    keep = torch.tensor([1.0, 1.0, 0.0], dtype=s.dtype, device=s.device)
    return (u * (s * keep)[..., None, :]) @ vh


def _sampson(F: torch.Tensor, p0: torch.Tensor,
             p1: torch.Tensor) -> torch.Tensor:
    """Sampson distance for x1^T F x0 = 0: F [..., 3, 3], p0/p1
    [..., N, 2] -> [..., N]."""
    ph0 = torch.cat([p0, torch.ones_like(p0[..., :1])], dim=-1)
    ph1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    fx0 = ph0 @ F.transpose(-1, -2)      # lines in image 1
    ftx1 = ph1 @ F                       # lines in image 0
    num = (ph1 * fx0).sum(-1)
    den = (fx0[..., 0] ** 2 + fx0[..., 1] ** 2 + ftx1[..., 0] ** 2
           + ftx1[..., 1] ** 2)
    return num.abs() / torch.sqrt(den.clamp_min(1e-18))


def ransac_fundamental_from_samples(p0: torch.Tensor, p1: torch.Tensor,
                                    mask: torch.Tensor, idx: torch.Tensor,
                                    thresh: float = 3.0):
    """8-point RANSAC for F (x1^T F x0 = 0) over given minimal samples idx
    [..., n_hyp, 8]; p0, p1 [..., K, 2] pixel coordinates, mask [..., K].
    Every hypothesis is solved on Hartley-normalized points and projected
    to rank 2. Returns (F [..., 3, 3], inliers [..., K], ok [...])."""
    q0, q1 = _take(p0, idx), _take(p1, idx)
    ones = torch.ones_like(q0[..., 0])
    t0 = _normalize_pts(q0, ones)
    t1 = _normalize_pts(q1, ones)
    fn = _rank2(_solve_eightpoint(_apply_T(t0, q0), _apply_T(t1, q1), ones))
    fs = t1.transpose(-1, -2) @ (fn @ t0)                 # [..., n_hyp, 3, 3]
    res = _sampson(fs, p0[..., None, :, :], p1[..., None, :, :])
    inl = (res < thresh) & mask[..., None, :]
    counts = inl.sum(-1)
    best = counts.argmax(-1)
    w = _rows(inl, best).float()
    t0 = _normalize_pts(p0, w)
    t1 = _normalize_pts(p1, w)
    fn = _rank2(_solve_eightpoint(_apply_T(t0, p0), _apply_T(t1, p1), w))
    F = t1.transpose(-1, -2) @ (fn @ t0)
    final = (_sampson(F, p0, p1) < thresh) & mask
    ok = (mask.sum(-1) >= 8) & (_rows(counts, best) >= 8)
    return F, final, ok


def ransac_fundamental(p0: torch.Tensor, p1: torch.Tensor, mask: torch.Tensor,
                       generator: torch.Generator, n_hyp: int = 512,
                       thresh: float = 3.0):
    """p0, p1 [..., K, 2] pixel coordinates, mask [..., K]; minimal samples
    drawn from `generator` (on the tensors' device). Returns (F [..., 3, 3],
    inliers [..., K], ok [...])."""
    idx = _sample_minimal(mask, n_hyp, 8, generator)
    return ransac_fundamental_from_samples(p0, p1, mask, idx, thresh)


def _threshold(thresh, ref: torch.Tensor, n_new: int) -> torch.Tensor:
    """A scalar or per-batch [...] threshold with n_new trailing 1-dims, to
    compare with residuals of ref's device."""
    th = torch.as_tensor(thresh, dtype=torch.float32, device=ref.device)
    return th.reshape(*th.shape, *([1] * n_new))


def _essential_project(E: torch.Tensor) -> torch.Tensor:
    """The nearest essential matrix: singular values (m, m, 0) with m the
    mean of the largest two."""
    u, s, vh = torch.linalg.svd(E)
    m = (s[..., 0] + s[..., 1]) / 2.0
    sv = torch.stack([m, m, torch.zeros_like(m)], dim=-1)
    return (u * sv[..., None, :]) @ vh


def ransac_essential_from_samples(p0n: torch.Tensor, p1n: torch.Tensor,
                                  mask: torch.Tensor, idx: torch.Tensor,
                                  thresh=1e-3):
    """8-point essential RANSAC on normalized camera coordinates p0n, p1n
    [..., K, 2] with mask [..., K], over given minimal samples idx
    [..., n_hyp, 8]. Hypotheses solve the raw coordinates (no Hartley
    normalization; on CUDA in float64, `_solve_minimal_e`) and are
    projected onto the essential manifold; the winner (most inliers, the
    first on ties) is refit 3 times on its inliers, plainly (the JAX
    package measured a normalized refit and a best-so-far guard and kept
    neither, geometry/ransac.py:376-390; on CUDA in float64,
    `_solve_eightpoint_e`).
    `thresh` is a Sampson threshold, scalar or [...]. Returns (E [..., 3,
    3], inliers [..., K], ok [...])."""
    with profiling.span("kbt.geometry.ransac.solve"):
        q0, q1 = _take(p0n, idx), _take(p1n, idx)
        e9, valid = _solve_minimal_e(q0, q1)
        es = _essential_project(e9)
    with profiling.span("kbt.geometry.ransac.score"):
        res = _sampson(es, p0n[..., None, :, :], p1n[..., None, :, :])
        inl = (res < _threshold(thresh, res, 2)) & mask[..., None, :] \
            & valid[..., None]
        counts = inl.sum(-1)
        best = counts.argmax(-1)
    with profiling.span("kbt.geometry.ransac.refit"):
        th = _threshold(thresh, res, 1)
        w = _rows(inl, best).float()
        for _ in range(3):
            E = _essential_project(_solve_eightpoint_e(p0n, p1n, w))
            w = ((_sampson(E, p0n, p1n) < th) & mask).float()
        ok = (mask.sum(-1) >= 8) & (_rows(counts, best) >= 8)
    return E, w > 0, ok


def ransac_essential(p0n: torch.Tensor, p1n: torch.Tensor,
                     mask: torch.Tensor, generator: torch.Generator,
                     n_hyp: int = 512, thresh=1e-3):
    """As `ransac_essential_from_samples`, with the minimal samples drawn
    from `generator` (on the tensors' device)."""
    idx = _sample_minimal(mask, n_hyp, 8, generator)
    return ransac_essential_from_samples(p0n, p1n, mask, idx, thresh)


def _triangulate_depths(R: torch.Tensor, t: torch.Tensor, u0: torch.Tensor,
                        u1: torch.Tensor):
    """Least-squares depths along normalized rays u0 (camera 0) and u1
    (camera 1), [..., K, 3], with X1 = R X0 + t: z0 (R u0 x u1) =
    -(t x u1). Returns (z0, z1) [..., K]."""
    ru0 = u0 @ R.transpose(-1, -2)
    a = torch.linalg.cross(ru0, u1, dim=-1)
    b = -torch.linalg.cross(t[..., None, :], u1, dim=-1)
    z0 = (a * b).sum(-1) / (a * a).sum(-1).clamp_min(1e-18)
    x1 = z0[..., None] * ru0 + t[..., None, :]
    return z0, x1[..., 2]


def decompose_essential(E: torch.Tensor):
    """E [..., 3, 3] -> (R1, R2, t): the four candidate poses are (R1, t),
    (R1, -t), (R2, t) and (R2, -t)."""
    u, _, vh = torch.linalg.svd(E)
    # proper rotations
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vh = vh * torch.sign(torch.linalg.det(vh))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return u @ (W @ vh), u @ (W.T @ vh), u[..., :, 2]


def recover_pose(E: torch.Tensor, p0n: torch.Tensor, p1n: torch.Tensor,
                 mask: torch.Tensor):
    """cv2.recoverPose on normalized camera coordinates: of the four poses
    of E, the one with the most masked points in front of both cameras
    (the first on ties, in the order of `decompose_essential`). Returns
    (R [..., 3, 3], t [..., 3], pose_mask [..., K], count [...])."""
    R1, R2, t = decompose_essential(E)
    u0 = torch.cat([p0n, torch.ones_like(p0n[..., :1])], dim=-1)
    u1 = torch.cat([p1n, torch.ones_like(p1n[..., :1])], dim=-1)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)             # [..., 4, 3, 3]
    ts = torch.stack([t, -t, t, -t], dim=-2)               # [..., 4, 3]
    z0, z1 = _triangulate_depths(Rs, ts, u0[..., None, :, :],
                                 u1[..., None, :, :])
    goods = (z0 > 0) & (z1 > 0) & mask[..., None, :]       # [..., 4, K]
    counts = goods.sum(-1)
    best = counts.argmax(-1)
    return (_rows(Rs, best), _rows(ts, best), _rows(goods, best),
            _rows(counts, best))
