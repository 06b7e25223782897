"""The benchmark's yardstick: the H100's peaks, the kernels' least times
from their shapes, the window's arithmetic and the host-sync count.

The bound functions are copies of `chip_smoke.py`'s (`match_bound`,
`nms_bound`, `sample_bound` with the sampler's plain taps), kept here so
that an edit of that script cannot move them. Each returns (least ms,
"bytes" or "operations"): the larger of the bytes over the HBM rate and
the operations over the f32 rate, an FMA counted 2 and compares and adds
at half that rate.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

# H100 SXM (NVIDIA's data sheet): HBM bytes/s; f32 FLOP/s outside the
# tensor cores, an FMA counting 2. Compares, max and adds issue at most one
# per f32 lane and clock, half the FMA-counted rate.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
PEAK_F32_OPS = PEAK_F32 / 2


def _least(t_bytes: float, t_ops: float):
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def match_bound(bsz: int, m: int, n: int, d: int):
    """Kernel D on a [B,M,D], b [B,N,D]: both read once, an index and a
    distance written per row and column; 2 M N D FLOPs of the products,
    5 operations per (i, j): two norms added, 2ab scaled and subtracted,
    a compare for the row and for the column minimum."""
    t_bytes = (4 * bsz * (m + n) * d + 8 * bsz * (m + n)) / PEAK_BYTES
    t_ops = (2 * bsz * m * n * d / PEAK_F32
             + 5 * bsz * m * n / PEAK_F32_OPS)
    return _least(t_bytes, t_ops)


def nms_bound(n_maps: int, h: int, w: int, rounds_total: int):
    """Kernel A on n_maps f32 [h, w] maps that needed `rounds_total`
    rounds between them: each map read and written once; per pixel 14
    operations for the local-max mask (two sliding maxima by van Herk /
    Gil-Werman, the before / after maxima, the compares, the count) and 7
    for a suppression (a box count by running sums, the compare and the
    select); the mask once before the rounds, both in every round."""
    hw = h * w
    t_bytes = 2 * n_maps * hw * 4 / PEAK_BYTES
    ops = (rounds_total * (14 + 7) + n_maps * 14) * hw
    return _least(t_bytes, ops / PEAK_F32_OPS)


def _onehot4(idx):
    return (idx[..., None] == torch.arange(4, device=idx.device)).float()


def _taps_direct(p, n: int):
    """Plain bilinear taps on one axis: (y0 = clip(floor p, 0, n - 2), the
    two weights from the unclipped floor)."""
    y0f = torch.floor(p)
    dy = p - y0f
    return torch.clamp(y0f.long(), 0, n - 2), torch.stack([1.0 - dy, dy], -1)


def _taps_up(p, n_hi: int, n_lo: int):
    """The taps on the low-resolution axis of sampling its align-corners
    upsample to n_hi at p: (base, 4 weights over base..base+3)."""
    y0f = torch.floor(p)
    dy = p - y0f
    y0 = y0f.long()
    s = (n_lo - 1.0) / (n_hi - 1.0)

    def lo_frac(y):
        src = y.float() * s
        lo = torch.clamp(torch.floor(src).long(), 0, n_lo - 2)
        return lo, src - lo

    la, fa = lo_frac(y0)
    lb, fb = lo_frac(torch.clamp_max(y0 + 1, n_hi - 1))
    base = torch.clamp(la, 0, n_lo - 4)
    oa, ob = la - base, lb - base
    wts = ((1.0 - dy)[..., None] * ((1.0 - fa)[..., None] * _onehot4(oa)
                                    + fa[..., None] * _onehot4(oa + 1))
           + dy[..., None] * ((1.0 - fb)[..., None] * _onehot4(ob)
                              + fb[..., None] * _onehot4(ob + 1)))
    return base, wts


def sample_bound(shapes, elem_bytes: int, px, py, h: int, w: int):
    """Kernel B on branch maps of `shapes` ([B,C,h_i,w_i] each, branch 0
    at h x w) at pixel coordinates px, py [B,K]: each distinct map value
    that a tap of non-zero weight needs read once (all channels), the
    coordinates read once and the samples written once; 2 FLOPs per tap
    product."""
    b, k = px.shape
    nbytes = 2 * px.numel() * 4
    flops = 0
    for i, (_, c, hi, wi) in enumerate(shapes):
        if i == 0:
            rb, wr = _taps_direct(py, hi)
            cb, wc = _taps_direct(px, wi)
        else:
            rb, wr = _taps_up(py, h, hi)
            cb, wc = _taps_up(px, w, wi)
        t = wr.shape[-1]
        ar = torch.arange(t, device=px.device)
        used = (wr[..., :, None] != 0) & (wc[..., None, :] != 0)
        rows = (rb[..., None] + ar)[..., :, None].expand(used.shape)
        cols = (cb[..., None] + ar)[..., None, :].expand(used.shape)
        bidx = torch.arange(b, device=px.device)[:, None, None, None]
        flat = ((bidx.expand(used.shape)[used] * hi + rows[used]) * wi
                + cols[used])
        nbytes += int(torch.unique(flat).numel()) * c * elem_bytes
        nbytes += b * c * k * 4
        flops += 2 * b * c * k * (t * t + t)
    return _least(nbytes / PEAK_BYTES, flops / PEAK_F32)


def host_syncs(fn) -> list[str]:
    """The synchronising operations one fn() makes, as
    torch.cuda.set_sync_debug_mode reports them (first lines)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [str(x.message).splitlines()[0] for x in caught
            if "synchroniz" in str(x.message)]

# --- the window's arithmetic -------------------------------------------------


def rate(units: int, window_s: float) -> float:
    """All the work of the window over all of its time."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return units / window_s


def p95(values) -> float:
    """The 95th percentile of every value (linear between order
    statistics, numpy's default)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, np.float64), 95))

