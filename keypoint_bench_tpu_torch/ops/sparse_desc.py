"""Sparse (keypoint-only) ALIKE descriptors (counterpart of
keypoint_bench_tpu/ops/sparse_desc.py).

Bilinear sampling, align-corners upsampling and the 1x1 head are linear,
so sampling the dense descriptor map at a keypoint equals the head applied
to per-branch samples of the raw branch features:

    sample(p, head(concat_i up_i(a_i))) == sum_i head_i(sample_up(p, a_i))

`sample_up` expands both interpolations exactly: the sample interpolates
four integer-grid corners of the upsampled map, each of which interpolates
two low-resolution entries, so one axis touches at most 4 consecutive
low-resolution rows (`_axis_taps_up`). The gathers here are the plain
version of kernel B (ops/cuda_sample.py), which the batched channel-major
entry points launch on CUDA tensors.

bf16 branch features round where the JAX package rounds. The batched
channel-major sampler is kernel B's semantics (JAX `pallas_sample._kernel`
and `_sorted_kernel`): column tap weights rounded to bf16, row weights,
sums and output f32. The per-map samplers `sample_direct` /
`sample_upsampled` are JAX's "mm" sampler on bf16 maps
(`_apply_weight_mats`): row and column weights rounded to bf16, the row
contraction stored in bf16, the column contraction f32. The aggregation
head stays f32 on both.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.models.common import resize_bilinear_align
from keypoint_bench_tpu_torch.ops import cuda_sample
from keypoint_bench_tpu_torch.ops.grid_sample import sample_bilinear_pixels

# The JAX package's y-ordered API sorts only where its row-band TPU kernel
# applies (pallas_sample.sorted_supported: every branch at least 4 x 4 and
# ROWS0 = 80 resident rows); the port keeps that rule so its output order
# equals the reference's on every shape.
ROWS0 = 80


def _onehot4(idx: torch.Tensor) -> torch.Tensor:
    return (idx[..., None] == torch.arange(4, device=idx.device)).float()


def _bf16(w: torch.Tensor) -> torch.Tensor:
    """f32 weights rounded to bf16 (to nearest even), held in f32."""
    return w.to(torch.bfloat16).float()


def _axis_taps_up(p: torch.Tensor, n_hi: int, n_lo: int):
    """Composite taps along one axis: the sample of the align-corners
    upsample (n_lo -> n_hi) at full-res coordinate p [...] equals
    sum_j w[..., j] * low[base + j]. Returns (base [...] long, w [..., 4])."""
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
    w = ((1.0 - dy)[..., None]
         * ((1.0 - fa)[..., None] * _onehot4(oa)
            + fa[..., None] * _onehot4(oa + 1))
         + dy[..., None]
         * ((1.0 - fb)[..., None] * _onehot4(ob)
            + fb[..., None] * _onehot4(ob + 1)))
    return base, w


def _axis_taps_direct(p: torch.Tensor, n: int):
    """Plain bilinear taps along one axis: y0 = clip(floor(p), 0, n-2) with
    dy from the unclipped floor. Returns (y0 [...] long, w [..., 2])."""
    y0f = torch.floor(p)
    dy = p - y0f
    y0 = torch.clamp(y0f.long(), 0, n - 2)
    return y0, torch.stack([1.0 - dy, dy], dim=-1)


def _axis_taps_merged(p: torch.Tensor, n_hi: int, n_lo: int):
    """Kernel B's composite taps along one axis (csrc/sample.cu `taps_up`):
    the taps la, la+1, lb, lb+1 with lb == la or la + 1 merged onto rows
    la..la+2 of the low-resolution axis (n_lo >= 2). Returns (la [...]
    long, w [..., 3]), each weight equal to `_axis_taps_up`'s in f32."""
    y0f = torch.floor(p)
    dy = p - y0f
    y0 = y0f.long()
    s = (n_lo - 1.0) / (n_hi - 1.0)

    def lo_frac(y):
        src = y.float() * s
        lo = torch.clamp(torch.floor(src).long(), 0, n_lo - 2)
        return lo, src - lo

    la, fa = lo_frac(y0)
    lb, fb = lo_frac(torch.clamp_max(y0, n_hi - 2) + 1)
    a0, a1 = (1.0 - dy) * (1.0 - fa), (1.0 - dy) * fa
    b0, b1 = dy * (1.0 - fb), dy * fb
    three = lb == la + 1
    return la, torch.stack([torch.where(three, a0, a0 + b0),
                            torch.where(three, a1 + b0, a1 + b1),
                            torch.where(three, b1, torch.zeros_like(b1))],
                           -1)


def _patches(f: torch.Tensor, rbase, cbase, t: int) -> torch.Tensor:
    """The [B,C,K,T,T] f32 windows of f [B,C,h,w] at rows rbase.. and
    columns cbase.. [B,K]; a row or column past the map (a merged tap of
    weight 0) reads the last one."""
    b, c, h, w = f.shape
    k = rbase.shape[1]
    ar = torch.arange(t, device=f.device)
    idx = ((rbase[..., None] + ar).clamp_max(h - 1)[..., :, None] * w
           + (cbase[..., None] + ar).clamp_max(w - 1)[..., None, :])
    patch = f.reshape(b, c, h * w).gather(
        2, idx.reshape(b, 1, k * t * t).expand(b, c, k * t * t))
    return patch.reshape(b, c, k, t, t).float()


def _sample_cm(f: torch.Tensor, rbase, wr, cbase, wc) -> torch.Tensor:
    """Patch gather + tap contraction. f [B,C,h,w] channel-major; rbase/
    cbase [B,K]; wr/wc [B,K,T] -> [B,C,K] f32."""
    return torch.einsum("bka,bkq,bckaq->bck", wr, wc,
                        _patches(f, rbase, cbase, wr.shape[-1]))


def _sample_mm(f: torch.Tensor, rbase, wr, cbase, wc) -> torch.Tensor:
    """`_sample_cm` as JAX's "mm" sampler computes it on a bf16 map
    (`_apply_weight_mats`): weights rounded to bf16, the row contraction
    stored in bf16, the column contraction f32 -> [B,C,K] f32."""
    patch = _patches(f, rbase, cbase, wr.shape[-1])
    t = torch.einsum("bka,bckaq->bckq", _bf16(wr), patch)
    return torch.einsum("bkq,bckq->bck", _bf16(wc),
                        t.to(torch.bfloat16).float())


def _per_map(feat: torch.Tensor, rbase, wr, cbase, wc) -> torch.Tensor:
    """One NHWC map [h,w,C] sampled at [K] taps -> [K,C] f32: the mm
    sampler's rounding for a bf16 map, f32 otherwise."""
    sample = _sample_mm if feat.dtype == torch.bfloat16 else _sample_cm
    out = sample(feat.permute(2, 0, 1)[None], rbase[None], wr[None],
                 cbase[None], wc[None])
    return out[0].T


def sample_direct(feat: torch.Tensor, px: torch.Tensor,
                  py: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a full-res feature [h,w,C] at pixel coords ->
    [K,C] (sample_bilinear_pixels for in-bounds points)."""
    rbase, wr = _axis_taps_direct(py, feat.shape[0])
    cbase, wc = _axis_taps_direct(px, feat.shape[1])
    return _per_map(feat, rbase, wr, cbase, wc)


def sample_upsampled(feat: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                     h_hi: int, w_hi: int) -> torch.Tensor:
    """Sample the align-corners upsample of feat [h_lo,w_lo,C] to
    (h_hi, w_hi) at full-res pixel coords without building it -> [K,C]."""
    h_lo, w_lo = feat.shape[0], feat.shape[1]
    if h_lo < 4 or w_lo < 4:
        # tiny maps: dense fallback, same math
        up = resize_bilinear_align(feat.permute(2, 0, 1)[None].float(),
                                   h_hi, w_hi)[0].permute(1, 2, 0)
        return sample_bilinear_pixels(up, px, py)
    rbase, wr = _axis_taps_up(py, h_hi, h_lo)
    cbase, wc = _axis_taps_up(px, w_hi, w_lo)
    return _per_map(feat, rbase, wr, cbase, wc)


def sample_branches(feats_b, px_b: torch.Tensor, py_b: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """Plain version of kernel B: feats_b tuple of channel-major
    [B,C,H_i,W_i] (branch 0 at full res h x w); px_b/py_b [B,K] pixel
    coords -> branch-stacked samples [B, sum C_i, K] f32."""
    if feats_b[0].dtype == torch.bfloat16:
        return _sample_branches_bf16(feats_b, px_b, py_b, h, w)
    outs = []
    for i, f in enumerate(feats_b):
        h_lo, w_lo = f.shape[-2], f.shape[-1]
        if i == 0:
            rb, wr = _axis_taps_direct(py_b, h_lo)
            cb, wc = _axis_taps_direct(px_b, w_lo)
        elif h_lo < 4 or w_lo < 4:
            outs.append(torch.stack([
                sample_upsampled(f[j].permute(1, 2, 0), px_b[j], py_b[j],
                                 h, w).T for j in range(f.shape[0])]))
            continue
        else:
            rb, wr = _axis_taps_up(py_b, h, h_lo)
            cb, wc = _axis_taps_up(px_b, w, w_lo)
        outs.append(_sample_cm(f, rb, wr, cb, wc))
    return torch.cat(outs, dim=1)


def _sample_branches_bf16(feats_b, px_b: torch.Tensor, py_b: torch.Tensor,
                          h: int, w: int) -> torch.Tensor:
    """`sample_branches` on bf16 maps, as kernel B's bf16 instantiation
    computes it: the merged windows of every branch (2- and 3-row maps
    too), the column weights rounded to bf16, f32 sums."""
    outs = []
    for i, f in enumerate(feats_b):
        if i == 0:
            rb, wr = _axis_taps_direct(py_b, f.shape[-2])
            cb, wc = _axis_taps_direct(px_b, f.shape[-1])
        else:
            rb, wr = _axis_taps_merged(py_b, h, f.shape[-2])
            cb, wc = _axis_taps_merged(px_b, w, f.shape[-1])
        outs.append(_sample_cm(f, rb, wr, cb, _bf16(wc)))
    return torch.cat(outs, dim=1)


def _apply_head(params: dict, o: torch.Tensor) -> torch.Tensor:
    """Branch-stacked samples [..., 64, K] -> descriptors [..., K, 64]
    through the aggregation head's descriptor rows, in f32 (bf16 mode's
    head weights are upcast)."""
    wd = params["convhead2.weight"][:-1, :, 0, 0].float()         # [64, 64]
    desc = torch.einsum("...qk,dq->...kd", o, wd)
    bh = params.get("convhead2.bias")
    if bh is not None:
        desc = desc + bh[:-1]
    return desc


def alike_sparse_descriptors(params: dict, feats, kpts: torch.Tensor,
                             h: int, w: int) -> torch.Tensor:
    """Descriptors at kpts [K,>=2] (normalized x, y) from one map's NHWC
    branch features (a1 [h,w,16], a2 @/2, a3 @/8, a4 @/32) -> [K,64],
    equal to sampling the dense descriptor map."""
    a1, a2, a3, a4 = feats
    px = kpts[:, 0] * (w - 1.0)
    py = kpts[:, 1] * (h - 1.0)
    wd = params["convhead2.weight"][:-1, :, 0, 0].float()
    per = a2.shape[-1]
    samples = [sample_direct(a1, px, py)] + [
        sample_upsampled(a, px, py, h, w) for a in (a2, a3, a4)]
    desc = sum(s @ wd[:, i * per:(i + 1) * per].T
               for i, s in enumerate(samples))
    bh = params.get("convhead2.bias")
    if bh is not None:
        desc = desc + bh[:-1]
    return desc


def alike_sparse_descriptors_cm_batch(params: dict, feats_b,
                                      kpts_b: torch.Tensor, h: int,
                                      w: int) -> torch.Tensor:
    """Channel-major batched descriptors: feats_b tuple of [B,16,H_i,W_i],
    kpts_b [B,K,>=2] -> [B,K,64] f32. Kernel B on CUDA tensors."""
    px = kpts_b[..., 0] * (w - 1.0)
    py = kpts_b[..., 1] * (h - 1.0)
    o = cuda_sample.fused_samples_batch(feats_b, px, py, h, w)
    return _apply_head(params, o)


def _sorted_supported(feats_b, h: int) -> bool:
    return (all(min(f.shape[-2:]) >= 4 for f in feats_b) and h >= ROWS0
            and (h - ROWS0) % 8 == 0)


def row_tap_keys(kpts_b: torch.Tensor, h: int) -> torch.Tensor:
    """Sort key of the y-ordered API: branch 0's row tap
    y0 = clip(floor(y * (h-1)), 0, h-2), [B,K] long."""
    return torch.clamp(torch.floor(kpts_b[..., 1] * (h - 1.0)).long(),
                       0, h - 2)


def alike_sparse_descriptors_cm_batch_yorder(params: dict, feats_b,
                                             kpts_b: torch.Tensor,
                                             valid_b: torch.Tensor,
                                             h: int, w: int):
    """Like `alike_sparse_descriptors_cm_batch`, but returns (desc [B,K,64],
    kpts [B,K,3], valid [B,K]) all permuted into the stable order of the
    row tap y0, as the reference's band kernel emits them. Mutual-NN
    matching is permutation-equivariant, so match counts and matched pairs
    are those of the original order. (The reference pads K to a multiple
    of 128 with slots keyed h, which sort last and are dropped: the order
    of the K real keypoints is the same without them.) Shapes where the
    reference's band kernel does not apply return the original order."""
    if not _sorted_supported(feats_b, h):
        desc = alike_sparse_descriptors_cm_batch(params, feats_b, kpts_b,
                                                 h, w)
        return desc, kpts_b[..., :3], valid_b
    _, order = torch.sort(row_tap_keys(kpts_b, h), dim=1, stable=True)
    kpts_s = kpts_b[..., :3].gather(1, order[..., None].expand(-1, -1, 3))
    valid_s = valid_b.gather(1, order)
    desc = alike_sparse_descriptors_cm_batch(params, feats_b, kpts_s, h, w)
    return desc, kpts_s, valid_s
