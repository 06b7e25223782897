"""Five-point minimal essential-matrix solver (Stewenius et al., "Recent
developments on direct relative orientation") and its RANSAC
(counterpart of keypoint_bench_tpu/geometry/fivepoint.py; the reference
computes AUC with cv2.findEssentialMat's five-point kernel, tasks/AUC.py:50).

The JAX package's algorithm, with leading batch dimensions throughout:
  * the 4-dim E-nullspace of the 5 epipolar constraints from `eigh` of
    A^T A;
  * the 10 x 20 constraint template, det(E) = 0 and the 9 entries of
    2 E E^T E - tr(E E^T) E, built by polynomial arithmetic on monomial
    exponents: a polynomial in (x, y, z) of degree <= 3 is its 20
    coefficients over `_MON20`, and a product of two is their outer
    product summed onto the monomial of each pair of exponents (`_MUL`,
    made from the exponents, not a table of coefficients);
  * Gauss-Jordan (one linear solve) for the 10 x 10 action matrix of
    multiplication by z, then 12 sweeps of diagonal balancing;
  * the real roots by sign changes of det(T - z I) (the sign of a batched
    `slogdet`) on a 256-point sinh grid within the Gershgorin bound, then
    40 bisection steps;
  * x, y from the right singular vector of the smallest singular value of
    T - z I, with the denominator rule and the 1e-12 guards.
Complex roots give no real essential matrix; a root of even multiplicity
changes no sign and is missed, as in the JAX package.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.geometry.ransac import (
    _essential_project, _rows, _sample_minimal, _sampson, _solve_eightpoint,
    _take, _threshold)

# Monomials in (x, y, z): the 10 of degree 3 first (eliminated), then the
# 10 of degree <= 2 (the quotient basis).
_DEG3 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
         (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_BASIS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
          (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MON20 = _DEG3 + _BASIS
_MON_IDX = {m: i for i, m in enumerate(_MON20)}
_BASIS_IDX = {m: i for i, m in enumerate(_BASIS)}


def _mul_matrix() -> torch.Tensor:
    """[400, 20]: row 20 i + j is the monomial of _MON20[i] * _MON20[j]
    (no row where the product's degree passes 3)."""
    out = torch.zeros(400, 20)
    for i, a in enumerate(_MON20):
        for j, b in enumerate(_MON20):
            e = (a[0] + b[0], a[1] + b[1], a[2] + b[2])
            if e in _MON_IDX:
                out[20 * i + j, _MON_IDX[e]] = 1.0
    return out


_MUL = _mul_matrix()


def _pmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of polynomials a, b [..., 20] whose degrees sum to <= 3."""
    outer = a[..., :, None] * b[..., None, :]
    return outer.flatten(-2) @ _MUL.to(a.device, a.dtype)


def _null4(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """5 correspondences p0, p1 [..., 5, 2] (normalized camera coordinates)
    -> the 4-dim nullspace of their epipolar constraints as an E-basis
    [..., 4, 3, 3]."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    o = torch.ones_like(x0)
    a = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, o],
                    dim=-1)                                  # [..., 5, 9]
    _, vecs = torch.linalg.eigh(a.transpose(-1, -2) @ a)     # ascending
    return vecs[..., :, :4].transpose(-1, -2).unflatten(-1, (3, 3))


def _template(eb: torch.Tensor) -> torch.Tensor:
    """E-basis [..., 4, 3, 3] -> the constraint template [..., 10, 20] over
    _MON20: det(E) = 0 and the 9 entries of 2 E E^T E - tr(E E^T) E."""
    # E's entries as degree-1 polynomials: x Eb0 + y Eb1 + z Eb2 + Eb3
    deg1 = torch.zeros(4, 20, dtype=eb.dtype, device=eb.device)
    for k, m in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]):
        deg1[k, _MON_IDX[m]] = 1.0
    e = torch.einsum("...kij,kc->...ijc", eb, deg1)          # [..., 3, 3, 20]
    eet = _pmul(e[..., :, None, :, :], e[..., None, :, :, :]).sum(-2)
    tr = eet[..., 0, 0, :] + eet[..., 1, 1, :] + eet[..., 2, 2, :]
    eete = _pmul(eet[..., :, None, :, :],
                 e.transpose(-2, -3)[..., None, :, :, :]).sum(-2)
    cons = 2.0 * eete - _pmul(tr[..., None, None, :], e)     # [..., 3, 3, 20]
    # det(E) by cofactors along the first row
    # E0j (E1a E2b - E1c E2d)
    cof = [(1, 2, 2, 1), (2, 0, 0, 2), (0, 1, 1, 0)]
    det = sum(_pmul(e[..., 0, j, :],
                    _pmul(e[..., 1, a, :], e[..., 2, b, :])
                    - _pmul(e[..., 1, c, :], e[..., 2, d, :]))
              for j, (a, b, c, d) in enumerate(cof))
    return torch.cat([det[..., None, :], cons.flatten(-3, -2)], dim=-2)


def _action_matrix(m: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan the template [..., 10, 20]: every degree-3 monomial
    is -B[i] . basis, and the action matrix T [..., 10, 10] of
    multiplication by z on _BASIS follows."""
    b = torch.linalg.solve_ex(m[..., :10], m[..., 10:])[0]   # [..., 10, 10]
    rows = []
    for mon in _BASIS:
        zm = (mon[0], mon[1], mon[2] + 1)
        if zm in _BASIS_IDX:
            row = torch.zeros_like(b[..., 0, :])
            row[..., _BASIS_IDX[zm]] = 1.0
            rows.append(row)
        else:
            rows.append(-b[..., _DEG3.index(zm), :])
    return torch.stack(rows, dim=-2)


def _balance(t: torch.Tensor, n_sweep: int = 12) -> torch.Tensor:
    """Diagonal similarity scaling D T D^-1 equalizing row and column
    norms, damped to [0.25, 4] a sweep: the eigenvalues stay, and the
    Gershgorin bound falls to about the spectral radius."""
    for _ in range(n_sweep):
        a = t.abs()
        diag = torch.diagonal(a, dim1=-2, dim2=-1)
        r = a.sum(-1) - diag
        c = a.sum(-2) - diag
        f = torch.sqrt(c.clamp_min(1e-30) / r.clamp_min(1e-30))
        f = f.clamp(0.25, 4.0)
        t = t * f[..., :, None] / f[..., None, :]
    return t


def _det_sign(t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """sign det(T - z I) for T [..., n, n] and z [..., g] -> [..., g]."""
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    return torch.linalg.slogdet(t[..., None, :, :]
                                - z[..., None, None] * eye)[0]


def _real_eigs_by_bisection(t: torch.Tensor, n_grid: int = 256,
                            n_bisect: int = 40):
    """The real eigenvalues of T [..., 10, 10] by sign changes of
    det(T - z I): (roots [..., 10], valid [..., 10]), the first 10 sign
    changes along the grid."""
    n = t.shape[-1]
    t = _balance(t)
    bound = t.abs().sum(-1).amax(-1) + 1e-3                  # Gershgorin
    # sinh-spaced grid: dense near 0, where the roots that matter cluster
    scale = 0.05
    u_max = torch.arcsinh(bound / scale)
    grid = torch.linspace(-1.0, 1.0, n_grid, dtype=t.dtype, device=t.device)
    zs = torch.sinh(grid * u_max[..., None]) * scale         # [..., G]
    signs = _det_sign(t, zs)
    flips = (signs[..., :-1] * signs[..., 1:]) < 0           # [..., G-1]
    # the first n sign changes: priority -index, ties by index
    pri = torch.where(flips, -torch.arange(n_grid - 1, dtype=t.dtype,
                                           device=t.device),
                      torch.full_like(zs[..., 1:], -torch.inf))
    take = torch.sort(pri, dim=-1, descending=True, stable=True)[1][..., :n]
    valid = flips.gather(-1, take)
    lo = zs.gather(-1, take)
    hi = zs.gather(-1, take + 1)
    s_lo = _det_sign(t, lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        s_mid = _det_sign(t, mid)
        left = s_mid * s_lo < 0
        lo, hi = torch.where(left, lo, mid), torch.where(left, mid, hi)
        s_lo = torch.where(left, s_lo, s_mid)
    return 0.5 * (lo + hi), valid


def five_point_candidates(p0: torch.Tensor, p1: torch.Tensor):
    """5 normalized-camera correspondences p0, p1 [..., 5, 2] -> up to 10
    essential matrices: (Es [..., 10, 3, 3] of unit Frobenius norm, valid
    [..., 10] bool)."""
    eb = _null4(p0, p1)
    t = _action_matrix(_template(eb))
    finite = torch.isfinite(t).flatten(-2).all(-1)
    eye = torch.eye(10, dtype=t.dtype, device=t.device)
    t = torch.where(finite[..., None, None], t, eye)
    zs, valid = _real_eigs_by_bisection(t)
    valid = valid & finite[..., None]
    # the null vector of T - z I: the right singular vector of the
    # smallest singular value
    v = torch.linalg.svd(t[..., None, :, :] - zs[..., None, None] * eye)[2]
    v = v[..., -1, :]                                        # [..., 10, 10]

    def at(m):
        return v[..., _BASIS_IDX[m]]

    # x and y are ratios of entries: (x/1, y/1) or (xz/z, yz/z), whichever
    # denominator is larger
    d1, dz = at((0, 0, 0)), at((0, 0, 1))
    use_z = dz.abs() > d1.abs()
    denom = torch.where(use_z, dz, d1)
    num_x = torch.where(use_z, at((1, 0, 1)), at((1, 0, 0)))
    num_y = torch.where(use_z, at((0, 1, 1)), at((0, 1, 0)))
    ok = denom.abs() > 1e-12
    safe = torch.where(ok, denom, torch.ones_like(denom))
    xs, ys = num_x / safe, num_y / safe
    es = (xs[..., None, None] * eb[..., None, 0, :, :]
          + ys[..., None, None] * eb[..., None, 1, :, :]
          + zs[..., None, None] * eb[..., None, 2, :, :]
          + eb[..., None, 3, :, :])
    norm = torch.linalg.vector_norm(es.flatten(-2), dim=-1)
    es = es / norm.clamp_min(1e-12)[..., None, None]
    return es, valid & ok & (norm > 1e-12)


def ransac_essential_5pt_from_samples(p0n: torch.Tensor, p1n: torch.Tensor,
                                      mask: torch.Tensor, idx: torch.Tensor,
                                      thresh=1e-3):
    """Five-point essential RANSAC on normalized camera coordinates p0n,
    p1n [..., K, 2] with mask [..., K], over given minimal samples idx
    [..., n_hyp, 5]. Every sample's candidates (up to 10) are scored by
    their Sampson residuals; the most inliers wins (the first on ties)
    and is refit 3 times on its inliers with the projected 8-point solve,
    as `ransac_essential_from_samples` refits. `thresh` is a Sampson
    threshold, scalar or [...]. Returns (E [..., 3, 3], inliers [..., K],
    ok [...])."""
    es, valid = five_point_candidates(_take(p0n, idx), _take(p1n, idx))
    es = es.flatten(-4, -3)                              # [..., 10 H, 3, 3]
    valid = valid.flatten(-2)
    res = _sampson(es, p0n[..., None, :, :], p1n[..., None, :, :])
    inl = (res < _threshold(thresh, res, 2)) & mask[..., None, :] \
        & valid[..., None]
    counts = inl.sum(-1)
    best = counts.argmax(-1)
    th = _threshold(thresh, res, 1)
    w = _rows(inl, best).float()
    for _ in range(3):
        E = _essential_project(_solve_eightpoint(p0n, p1n, w))
        w = ((_sampson(E, p0n, p1n) < th) & mask).float()
    ok = (mask.sum(-1) >= 5) & (_rows(counts, best) >= 5)
    return E, w > 0, ok


def ransac_essential_5pt(p0n: torch.Tensor, p1n: torch.Tensor,
                         mask: torch.Tensor, generator: torch.Generator,
                         n_hyp: int = 256, thresh=1e-3):
    """As `ransac_essential_5pt_from_samples`, with the minimal samples
    drawn from `generator` (on the tensors' device)."""
    idx = _sample_minimal(mask, n_hyp, 5, generator)
    return ransac_essential_5pt_from_samples(p0n, p1n, mask, idx, thresh)
