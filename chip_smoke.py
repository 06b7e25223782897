#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each fatal on failure:
  1. the card's name and power limit; build the six CUDA kernels from
     keypoint_bench_tpu_torch/csrc with nvcc, in parallel, and print what
     `-Xptxas -v` says of kernels B, D, E and F (registers, shared memory,
     spills);
  2. the ALIKE-t and SuperPoint forwards on the card vs the CPU at 128^2
     (atol 1e-4, f32 with TF32 off on both);
  3. kernel A (NMS fixpoint) vs its plain twin on real ALIKE-t score maps
     at 512^2, a tie-heavy bf16 map and a signed map: bit equality, one
     launch a call, the rounds each map ran; its cooperative grid, and the
     tiles it recomputed per round against the plain run's changed tile
     neighbourhoods; timed beside two bounds (full rounds, changed tiles);
  4. kernel B (sparse sampler) vs its plain twin on real branch features
     at 512^2, K=1000, original and y-sorted keypoint order, and on random
     features whose last branch is 3 x 3 or 2 x 2: max abs error <= 1e-5;
     timed in both orders (CUDA events) beside the plain twin, the bound
     of the distinct values and the bound of the 32-byte sectors a kernel
     reading the channel-major layout must move;
  5. the ALIKE-t path, `extract_match` at 512^2, 16 pairs, nms 6, border
     8, top_k 1000, max_distance 5, with the launch counts reset just
     before it (kernel A exactly twice, one launch a detection batch):
     keypoints and masks equal to the same pipeline through the plain
     twins, match count within 0.5% of the valid keypoints; then
     timed (median of 7 windows) with a per-stage breakdown, and, after
     the timings, kernel B's device time of a call from the profiler;
  6. synthetic repeatability (configs/repeatability_synthetic.yaml, 4
     pairs at 512^2) through the port's runner, equal to the plain-twin run;
  7. kernel D (nearest neighbours) vs its plain twin on real SuperPoint
     (D = 256) and ALIKE-t (D = 64, the main path's) descriptors at
     K = 1000 and on random unit descriptors at K = 4096 (D = 256), with
     invalid rows and columns (one penalty column each): indices equal
     except near ties (the two candidates' distances within 1e-5 of
     |a|^2 + |b|^2), distances within 1e-4 of it; bit-equal on integer
     descriptors; each of the three timed in turns with the library
     yardstick (baddbmm, then both minima with their indices), beside
     the plain twin, the bound and the device time of a call from the
     profiler;
  8. kernel E (masked attention) vs its plain twin within 1e-5 absolute
     and relative: 8 pairs x 2 sides x 4 heads at K = 1000 for both scales,
     all keys invalid (finite and uniform), n != m off the tile size; timed
     in turns with scaled_dot_product_attention (kernel, library, library,
     kernel);
  9. `superpoint_mha_step` at 512^2, nms 6, border 8, top_k 1000,
     max_distance 5, n_hyp 512 with brute force (16 pairs) and with
     LightGlue (8 pairs), launch counts reset just before each: matches
     and MHA hits against the plain-twin step on the same generator seed
     (0.5% match-count rule, differences in hits recorded), LightGlue's
     2-layer scores against the plain twins on the step's descriptors;
     then timed (median of 7 windows) with a per-stage breakdown, and one
     step under torch.profiler for the device's busy time and top kernels;
 10. the port's Evaluator: MHA with SuperPoint + light_glue on 4 synthetic
     pairs at 512^2 from golden weights staged under output/, equal to the
     plain-twin run;
 11. kernel E timed alone at K = 4096, in turns with the library call,
     whose device kernels are named from a profiled call;
 12. kernel F (one LK level) vs the plain `_lk_level` on 8 pairs of
     consecutive synthetic-sequence frames at 512^2, K = 1000: per level
     from the same start at 8 iterations, win 21 and win 3, on ALIKE-t's
     keypoints and on points within 3 px of the borders and corners (max
     abs error <= 5e-3 px; at win 3 on the border set, where systems are
     near-singular, at most 0.5% of the points beyond it); then the full
     protocol (3 levels x 40
     iterations, distance 10, same angles): at least 99% of the points
     within 1e-2 px of the plain run, the rest printed with their det;
     then each level timed from the starts the protocol gives it, in turns
     with the plain version, with the share of iterations that loaded a
     window;
 13. `lk_fundamental_step` (ALIKE-t -> detection -> LK 21 / 3 / 40 / 10 ->
     epipolar error) on those 8 pairs, launch counts reset just before it:
     keypoints equal to the plain-twin step, per-pair error within 1e-3
     relative, hit count within 0.5% of the valid keypoints; then timed
     (median of 7 windows) in frames/s with a per-stage breakdown and one
     step under torch.profiler;
 14. kernel C (the per-chunk peel) vs its plain version on ALIKE-t's NMS'd
     maps [16,512,512], a tie-heavy and a sparse map: bit equality; then
     `detection_batch_fused` vs `detection_batch` on the same score maps,
     launch counts reset just before it: keypoints and masks equal, the
     full-sort guard taken on the tie-heavy maps and not on the real ones;
     kernel C timed in turns with its library yardstick, torch.topk of
     every 128-column chunk of the same border-masked maps (values equal
     to C's); the two detection paths timed in turns;
 15. the port's Evaluator: FundamentalMatrix with optical_flow on 5
     synthetic-sequence frames at 512^2, per pair and pipelined, against
     the plain-twin runs on the same seed;
 16. a `kernels` JSON line and, last, the device JSON line.
Exits non-zero without CUDA, or without the port's package beside it.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE, SIZE, PAIRS, K = "cuda", 512, 16, 1000
LG_PAIRS, K_LARGE = 8, 4096     # LightGlue pairs; bench.py:314's second K
LK_PAIRS = 8                    # bench.py:430's batch of the LK step
# H100 SXM peaks (vendor datasheet): HBM bytes/s, f32 FLOP/s (an FMA
# counts 2). Compares, max and adds issue at most one per f32 lane and
# clock, half the FMA-counted rate.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
PEAK_F32_OPS = PEAK_F32 / 2


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fn, other, iters=10, other_iters=5):
    """(ms of fn, ms of other, the four readings): fn, other, other, fn
    timed one after the other on one card, each the mean of its two."""
    a1 = cuda_ms(fn, iters=iters)
    b1 = cuda_ms(other, iters=other_iters, warmup=1)
    b2 = cuda_ms(other, iters=other_iters, warmup=1)
    a2 = cuda_ms(fn, iters=iters)
    return (a1 + a2) / 2, (b1 + b2) / 2, [a1, b1, b2, a2]


def ptxas_info(name):
    """What `nvcc -Xptxas -v` reports for csrc/<name>.cu: the lines that
    name registers, shared memory, barriers and spills. Compiles to a
    throw-away cubin next to the built libraries."""
    from keypoint_bench_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"{name}.{os.getpid()}.cubin")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_build._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", out,
         os.path.join(_build.CSRC_DIR, f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.remove(out)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]


@contextlib.contextmanager
def plain_twins():
    """Route CUDA tensors through the kernels' plain twins (the reference
    the kernels are held against); restored on exit."""
    from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_lk,
                                              cuda_match, cuda_nms,
                                              cuda_sample)
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.ops.detect import fast_nms, peel_topk
    from keypoint_bench_tpu_torch.ops.lk import _lk_level
    from keypoint_bench_tpu_torch.ops.matching import nn_dists
    from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
    saved = (cuda_nms.nms_cuda, cuda_sample.sample_cuda,
             cuda_match.nn_dists_cuda, cuda_attention.attention_cuda,
             cuda_lk.lk_level_cuda, cuda_nms.peel_cuda)
    cuda_nms.nms_cuda = fast_nms
    cuda_sample.sample_cuda = sample_branches
    cuda_match.nn_dists_cuda = nn_dists
    cuda_attention.attention_cuda = fused_attention
    cuda_lk.lk_level_cuda = _lk_level
    cuda_nms.peel_cuda = peel_topk
    try:
        yield
    finally:
        (cuda_nms.nms_cuda, cuda_sample.sample_cuda,
         cuda_match.nn_dists_cuda, cuda_attention.attention_cuda,
         cuda_lk.lk_level_cuda, cuda_nms.peel_cuda) = saved


def kernel_handles():
    """The six kernels' launch counters, by the names in the JSON line."""
    from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_lk,
                                              cuda_match, cuda_nms,
                                              cuda_sample)
    return {"nms": cuda_nms.KERNEL, "sample": cuda_sample.KERNEL,
            "nn_match": cuda_match.KERNEL, "attention": cuda_attention.KERNEL,
            "lk": cuda_lk.KERNEL, "peel": cuda_nms.PEEL_KERNEL}


def reset_launches():
    for k in kernel_handles().values():
        k.launches = 0


def read_launches():
    return {n: k.launches for n, k in kernel_handles().items()}


def check_nn(got, want, a, b):
    """Kernel D's (nn01, d01, nn10, d10) against the plain twin's, in
    float64 from the inputs: indices equal except near ties (the two
    candidates' distances within 1e-5 of |a|^2 + |b|^2, the operands'
    scale), distances within 1e-4 of that scale. Returns ([near ties
    between penalty-free pairs, near ties where a penalty sits], max abs
    error of d over penalty-free pairs, max error relative to scale)."""
    a64, b64 = a.double(), b.double()
    near, err_free, rel = [0, 0], 0.0, 0.0
    for side, (x, y) in enumerate(((a64, b64), (b64, a64))):
        nn_g, d_g = got[2 * side].long(), got[2 * side + 1].double()
        nn_w, d_w = want[2 * side].long(), want[2 * side + 1].double()
        xn, yn = (x * x).sum(-1), (y * y).sum(-1)

        def dist(nn):
            yy = y.gather(1, nn[..., None].expand(*nn.shape, y.shape[-1]))
            return ((x - yy) ** 2).sum(-1), xn + yn.gather(-1, nn)

        dg, scale = dist(nn_g)
        dw, _ = dist(nn_w)
        differ = nn_g != nn_w
        if not bool(((dg - dw).abs() <= 1e-5 * scale)[differ].all()):
            raise AssertionError("kernel D picks a neighbour that is not a "
                                 "near tie of the plain twin's")
        e = (d_g - d_w).abs()
        if not bool((e <= 1e-4 * scale).all()):
            raise AssertionError(f"kernel D distances differ by "
                                 f"{float((e / scale).max())} of scale")
        free = scale < 1e4          # no penalty at either end
        near[0] += int((differ & free).sum())
        near[1] += int((differ & ~free).sum())
        rel = max(rel, float((e / scale).max()))
        if bool(free.any()):
            err_free = max(err_free, float(e[free].max()))
    return near, err_free, rel


def close_scores(got, want):
    """LightGlue log scores: masked entries masked on both sides, the
    difference's norm within 1e-4 of the reference's, each entry within
    1e-3 of the largest unmasked score. Returns the relative norm."""
    live = want > -1e8
    if not bool(((got > -1e8) == live).all()):
        raise AssertionError("LightGlue masks differ")
    diff = (got - want).abs()[live]
    rel = float(diff.norm() / want[live].norm())
    if not (float(diff.max()) <= 1e-3 * float(want[live].abs().max())
            and rel <= 1e-4):
        raise AssertionError(f"LightGlue scores differ: {rel}")
    return rel


def profile_step(step, top=6):
    """One step under torch.profiler: (device busy ms, host window ms,
    [(kernel, device ms)] of the `top` kernels by device time). Busy time
    is the union of the device activity intervals; the window spans every
    recorded event, host and device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy, end, per_kernel = 0.0, float("-inf"), {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + (b - a) / 1e3
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) if events else 0.0
    kernels = sorted(per_kernel.items(), key=lambda kt: -kt[1])[:top]
    return busy / 1e3, window / 1e3, kernels


def match_bound(a, b):
    """(ms, bound_by) of kernel D on a [B,M,D], b [B,N,D]: a and b read
    once, nn and d written once per row and column; 2*M*N*D FLOPs of the
    distance products at the FMA rate, plus 5 operations per (i, j) at the
    add / compare rate: the two norms added, 2ab scaled and subtracted, and
    one compare each for the row and the column minimum."""
    bsz, m, d = a.shape
    n = b.shape[1]
    t_bytes = (4 * bsz * (m + n) * d + 8 * bsz * (m + n)) / PEAK_BYTES
    t_ops = (2 * bsz * m * n * d / PEAK_F32
             + 5 * bsz * m * n / PEAK_F32_OPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(q, m):
    """(ms, bound_by, exps) of kernel E on q [..., n, 64] against m keys:
    q, k, v and the mask read once, the output written once; 4*n*m*dh
    FLOPs per slice (QK^T and PV) at the f32 FMA rate. The n*m
    exponentials are counted apart (the peak table has no rate for them)."""
    dh, n = q.shape[-1], q.shape[-2]
    g = q.numel() // (n * dh)
    t_bytes = (4 * g * dh * (2 * n + 2 * m) + g * m) / PEAK_BYTES
    t_ops = 4 * g * n * m * dh / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", g * n * m)


def nms_bound(maps, rounds):
    """(ms, bound_by): read + write each f32 map once; the operations the
    function needs, independent of d, per pixel:
      local-max mask, 14: the row maxima of the d values left and right of
        a pixel are one width-d sliding max (van Herk / Gil-Werman, 3 max),
        the full row max 2 more, the column maxima of that over the d rows
        above and below one more sliding max (3); before/after 2,
        the strict / >= compares and their and 3, the count 1;
      suppression, 7: a box count by running sums (2 per axis), minus the
        pixel itself, a compare and a select.
    The mask runs once before the rounds, both run in every round this
    run's maps needed; all at the compare / add rate."""
    n = maps.numel()
    hw = maps.shape[-1] * maps.shape[-2]
    t_bytes = 2 * n * 4 / PEAK_BYTES
    ops = (int(rounds.sum()) * (14 + 7) + maps.shape[0] * 14) * hw
    t_ops = ops / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nms_tile_work(maps, d, max_iter=30, min_value=0.0, tile=32):
    """The plain fixpoint's changes round by round, for kernel A's check and
    its recounted bound: (tiles whose mask, tiles whose suppression, need
    recomputing per round, summed over the batch; pixels whose mask,
    pixels whose suppression, need recomputing, over all rounds). A pixel's
    mask depends only on p within d of it, and its suppression only on the
    mask within d: a pixel needs its mask again where bits of p changed
    within d of it in that round's suppression, and its suppression where
    the mask changed within d of it in the round before, on maps still
    running. A tile needs them where such a change lies in its 3 x 3 tile
    neighbourhood (kernel A's granularity). Round 0's mask and round 1's
    suppression take every pixel. Built from ops/detect.py's plain phases,
    not from the kernel."""
    import torch
    import torch.nn.functional as F
    from keypoint_bench_tpu_torch.ops.detect import (_local_max_mask,
                                                     _others_in_window)
    p = maps.float()
    b, h, w = p.shape
    ty, tx = -(-h // tile), -(-w // tile)

    def near_tile(changed):
        pad = F.pad(changed.float(), (0, tx * tile - w, 0, ty * tile - h))
        per_tile = F.max_pool2d(pad[:, None], tile)
        return F.max_pool2d(per_tile, 3, 1, 1)[:, 0] > 0

    def near_px(changed):
        pooled = F.max_pool2d(changed.float()[:, None], 2 * d + 1, 1, d)
        return pooled[:, 0] > 0

    mv = torch.tensor(min_value, dtype=maps.dtype).float().item()
    mask = _local_max_mask(p, d)
    count = mask.sum((1, 2))
    prev = torch.full_like(count, -1)
    mask_changed = torch.ones_like(mask)
    mask_tiles, supp_tiles = [b * ty * tx], [0]
    mask_px, supp_px = b * h * w, 0
    for _ in range(max_iter):
        active = count != prev
        if not bool(active.any()):
            break
        live = active[:, None, None]
        supp_tiles.append(int((near_tile(mask_changed) & live).sum()))
        supp_px += int((near_px(mask_changed) & live).sum())
        supp = _others_in_window(mask, d) & live
        new_p = torch.where(supp, torch.full_like(p, mv), p)
        p_changed = new_p.view(torch.int32) != p.view(torch.int32)
        mask_tiles.append(int(near_tile(p_changed).sum()))
        mask_px += int(near_px(p_changed).sum())
        p = new_p
        new_mask = _local_max_mask(p, d)
        mask_changed = (new_mask != mask) & active[:, None, None]
        mask = torch.where(active[:, None, None], new_mask, mask)
        prev = torch.where(active, count, prev)
        count = torch.where(active, new_mask.sum((1, 2)), count)
    return mask_tiles, supp_tiles, mask_px, supp_px


def nms_change_bound(maps, mask_px, supp_px):
    """(ms, bound_by) of kernel A for the work this run's maps need, on the
    pixels nms_tile_work says need it: nms_bound's 14 operations a pixel
    for the mask (compares of floats); its 7 for the suppression at the
    word rate, 32 pixels an operation (the suppression of a bit mask works
    on 32 columns at once); each f32 map read and written once."""
    t_bytes = 2 * maps.numel() * 4 / PEAK_BYTES
    t_ops = (14 * mask_px + 7 * supp_px / 32) / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sample_taps_used(feats, px, py, h, w):
    """Per branch of kernel B's function: (channels, h_i, w_i, map, row,
    column of every tap with non-zero weight, taps an axis), from the plain
    taps on this run's keypoints."""
    import torch
    from keypoint_bench_tpu_torch.ops.sparse_desc import (_axis_taps_direct,
                                                          _axis_taps_up)
    b = px.shape[0]
    out = []
    for i, f in enumerate(feats):
        c, hi, wi = f.shape[1], f.shape[2], f.shape[3]
        if i == 0:
            rb, wr = _axis_taps_direct(py, hi)
            cb, wc = _axis_taps_direct(px, wi)
        else:
            rb, wr = _axis_taps_up(py, h, hi)
            cb, wc = _axis_taps_up(px, w, wi)
        t = wr.shape[-1]
        ar = torch.arange(t, device=px.device)
        used = (wr[..., :, None] != 0) & (wc[..., None, :] != 0)
        rows = (rb[..., None] + ar)[..., :, None].expand(used.shape)
        cols = (cb[..., None] + ar)[..., None, :].expand(used.shape)
        bidx = torch.arange(b, device=px.device)[:, None, None, None]
        out.append((c, hi, wi, bidx.expand(used.shape)[used], rows[used],
                    cols[used], t))
    return out


def sample_bound(feats, px, py, h, w):
    """(ms, bound_by): the feature values this run's keypoints need (taps
    with non-zero weight, distinct per map, all channels), the coordinates
    read once and the samples written once; 2 flops per tap product."""
    import torch
    b, k = px.shape
    nbytes = 2 * px.numel() * 4
    flops = 0
    for c, hi, wi, bi, r, q, t in sample_taps_used(feats, px, py, h, w):
        nbytes += int(torch.unique((bi * hi + r) * wi + q).numel()) * c * 4
        nbytes += b * c * k * 4                          # the samples out
        flops += 2 * b * c * k * (t * t + t)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sample_sector_bound(feats, px, py, h, w):
    """(ms, bound_by, feature bytes) of kernel B reading the channel-major
    features as they are laid out: one 32-byte sector per distinct (map,
    channel, row, sector) that a tap with non-zero weight touches, the
    coordinates read once and the samples written once; sample_bound's
    flops."""
    import torch
    b, k = px.shape
    nbytes = 2 * px.numel() * 4
    feat_bytes, flops = 0, 0
    for c, hi, wi, bi, r, q, t in sample_taps_used(feats, px, py, h, w):
        ch = torch.arange(c, device=px.device)[:, None]
        addr = ((bi[None] * c + ch) * hi + r[None]) * wi + q[None]
        feat_bytes += int(torch.unique(addr // 8).numel()) * 32
        nbytes += b * c * k * 4                          # the samples out
        flops += 2 * b * c * k * (t * t + t)
    nbytes += feat_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", feat_bytes)


def lk_bound(imgs, n, win, levels, iterations):
    """(ms, bound_by, point-iterations, ms with the gradients counted in
    every iteration) of kernel F over one optical_flow_batch on imgs
    [B,H,W,C] with n points per pair: both images of every pyramid level
    and the points read once, the tracked points written once; with T =
    win^2 * C taps and G = (win+1)^2 * C gradient corners:
      per point and iteration: three bilinear fields, one product and 3
        FMAs per tap and field; di and the five sums, one subtraction and
        5 FMAs per tap;
      per point and level, once: the template patch (one product, 3 FMAs
        per tap) and the gradients, separable: a 3-tap column (row) sum per
        corner, one FMA and one add, shared by its neighbours, and one
        subtraction, for each of dx and dy: 2 FMAs and 4 adds per corner.
    The gradients depend on the window's integer start alone, and the
    least an implementation needs is one window per point and level (a
    start that never moves), so the bound counts them once. The fourth
    value counts them in every iteration, as this bound did before the
    kernel cached its windows, so that earlier readings stay comparable.
    FMAs at the f32 FMA rate (2 FLOPs each), the rest at the add rate.
    The iteration count is fixed: no point stops early."""
    b, h, w, c = imgs.shape
    t, g = win * win * c, (win + 1) * (win + 1) * c
    pt_levels = b * n * levels
    pt_iters = pt_levels * iterations
    px = sum((h // 2 ** lv) * (w // 2 ** lv) for lv in range(levels))
    t_bytes = (2 * b * px * c * 4 + levels * 3 * b * n * 2 * 4) / PEAK_BYTES

    def t_ops(grad_times):
        fma = pt_iters * 14 * t + pt_levels * 3 * t + grad_times * 2 * g
        single = pt_iters * 4 * t + pt_levels * t + grad_times * 4 * g
        return 2 * fma / PEAK_F32 + single / PEAK_F32_OPS

    once, every = t_ops(pt_levels), t_ops(pt_iters)
    return (max(t_bytes, once) * 1e3,
            "bytes" if t_bytes >= once else "operations", pt_iters,
            max(t_bytes, every) * 1e3)


def peel_bound(maps, per_chunk):
    """(ms, bound_by) of kernel C on maps [B,H,W]: every value read once,
    per_chunk values and indices written per 128-column chunk; one compare
    per value and round at the compare rate."""
    b, h, w = maps.shape
    nc = (w // 128) * per_chunk
    t_bytes = (4 * b * h * w + 8 * b * h * nc) / PEAK_BYTES
    t_ops = per_chunk * b * h * w / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def border_points(b, n, h, w, gen, dev):
    """[b,n,2] points within 3 px of a border of an h x w image, inside or
    outside it; the first eight of every batch sit at the four corners."""
    import torch
    u = torch.rand((4, b, n), generator=gen, device=dev)
    x = u[0] * (w + 5) - 3
    y = u[1] * (h + 5) - 3
    near = u[2] * 6 - 3
    side = (u[3] * 4).long()
    x = torch.where(side == 0, near, torch.where(side == 1, w - 1 + near, x))
    y = torch.where(side == 2, near, torch.where(side == 3, h - 1 + near, y))
    corners = torch.tensor([[0.5, 0.5], [w - 1.5, 0.5], [0.5, h - 1.5],
                            [w - 1.5, h - 1.5], [-2.0, -2.0], [w + 1.0, -2.0],
                            [-2.0, h + 1.0], [w + 1.0, h + 1.0]], device=dev)
    pts = torch.stack([x, y], -1)
    pts[:, :8] = corners
    return pts


def lk_det(img2, pts, win):
    """det of the 2x2 Gauss-Newton system of `_lk_level` at pts [B,N,2] of
    img2 [B,H,W,C] (the quantity its 1e-6 guard tests)."""
    from keypoint_bench_tpu_torch.ops.lk import (_gradients, _pad_field,
                                                 _window_bilinear)
    import torch
    pad = win + 1
    dx, dy = _gradients(img2)
    f = _window_bilinear(_pad_field(torch.cat([dx, dy], -1), pad), pts, win,
                         pad)
    c = img2.shape[-1]
    jx, jy = f[..., :c].flatten(-3), f[..., c:].flatten(-3)
    return ((jx * jx).sum(-1) * (jy * jy).sum(-1)
            - (jx * jy).sum(-1) ** 2)


def timed_windows(step, windows=7, per_window=3, warmup=2):
    """Host seconds per step: `windows` windows of `per_window` steps, each
    ending in a device synchronize, after `warmup` steps."""
    import torch
    for _ in range(warmup):
        step()
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_window):
            step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / per_window)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "keypoint_bench_tpu_torch")):
        print("chip_smoke: keypoint_bench_tpu_torch/ is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from keypoint_bench_tpu_torch.datasets import get_dataset
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticSequenceDataset
    from keypoint_bench_tpu_torch.ops import (_build, cuda_attention,
                                              cuda_lk, cuda_match, cuda_nms,
                                              cuda_sample)
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch,
                                                     detection_batch_fused,
                                                     fast_nms,
                                                     fast_nms_rounds,
                                                     fused_topk, peel_topk,
                                                     remove_border)
    from keypoint_bench_tpu_torch.ops.lk import (LKParams, _avg_pool_img,
                                                 _lk_level, draw_angles,
                                                 optical_flow_batch_from_angles)
    from keypoint_bench_tpu_torch.ops.matching import (mutual_nn_match,
                                                       nn_dists, penalized)
    from keypoint_bench_tpu_torch.ops.sparse_desc import (
        alike_sparse_descriptors_cm_batch_yorder, row_tap_keys,
        sample_branches)
    import torch.nn.functional as F

    from keypoint_bench_tpu_torch.models.lightglue import (
        lightglue_scores, sample_descriptors_lg)
    from keypoint_bench_tpu_torch.ops.attention import fused_attention
    from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
    from keypoint_bench_tpu_torch.pipeline import (covisible, extract,
                                                   extract_match,
                                                   lk_fundamental_step,
                                                   match_pairs,
                                                   superpoint_detect,
                                                   superpoint_mha_step)
    from keypoint_bench_tpu_torch.tasks.fundamental import \
        fundamental_metrics
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.tasks.mha import mha_pair
    from keypoint_bench_tpu_torch.weights import (load_golden_params,
                                                  load_params,
                                                  stage_golden_weights)

    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    torch.manual_seed(0)

    with phase("build kernels (nvcc, parallel)"):
        t0 = time.perf_counter()
        with ThreadPoolExecutor() as pool:
            info = {n: pool.submit(ptxas_info, n)
                    for n in ("sample", "match", "attention", "lk")}
            list(pool.map(_build.build,
                          ["nms", "sample", "match", "attention", "lk",
                           "peel"]))
            ptxas = {n: f.result() for n, f in info.items()}
        log(f"build: {time.perf_counter() - t0:.1f} s")
        for name, lines in ptxas.items():
            for ln in lines:
                log(f"  ptxas {name}.cu: {ln}")
        tiles = [ctypes.c_int() for _ in range(3)]
        ctypes.CDLL(_build.build("attention")).kbt_attention_tiles(
            *map(ctypes.byref, tiles))
        bq, bk, att_smem = (t.value for t in tiles)
        log(f"  kernel E tiles: {bq} query rows x {bk} keys, {att_smem} bytes "
            f"of dynamic shared memory a block; kernel F: "
            f"{cuda_lk.smem_bytes(21, 3)} bytes a block at win 21, C 3, "
            f"{cuda_lk.block_threads(21, 3)} threads")
        if (bq, bk) != (cuda_attention.BQ, cuda_attention.BK):
            raise AssertionError("ops/cuda_attention.py BQ, BK differ from "
                                 "the built kernel's tiles")

    params = load_params("Alike", device=dev)
    model = get_model("Alike")(params).eval()
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)
    errs = {"nms": 0.0, "sample": 0.0, "nn_match": 0.0, "attention": 0.0,
            "lk": 0.0, "peel": 0.0}
    sp_params = load_golden_params("SuperPoint", dev)
    sp_model = get_model("SuperPoint")(sp_params).eval()
    lg_params = load_golden_params("lightglue", dev)

    with phase("forward: ALIKE-t and SuperPoint, card vs CPU at 128^2"):
        img = torch.from_numpy(np.random.default_rng(0).random(
            (1, 128, 128, 3), np.float32))
        for name, m_gpu, m_cpu in (
                ("Alike", model, get_model("Alike")(load_params("Alike"))),
                ("SuperPoint", sp_model, get_model("SuperPoint")(
                    load_golden_params("SuperPoint")))):
            with torch.inference_mode():
                s_gpu, d_gpu = m_gpu(img.to(dev))
                s_cpu, d_cpu = m_cpu(img)
            err = max(float((s_gpu.cpu() - s_cpu).abs().max()),
                      float((d_gpu.cpu() - d_cpu).abs().max()))
            log(f"  {name} forward max abs err {err:.3g}")
            if not err <= 1e-4:
                raise AssertionError(f"{name} forward card vs CPU: {err}")

    with phase("data: 16 synthetic homography pairs at 512^2"):
        ds = get_dataset({"type": "synthetic_homography",
                          "num_pairs": PAIRS, "image_size": SIZE})
        items = [ds[i] for i in range(PAIRS)]
        imgs0 = torch.from_numpy(np.stack([s["image0"] for s in items])).to(dev)
        imgs1 = torch.from_numpy(np.stack([s["image1"] for s in items])).to(dev)
        with torch.inference_mode():
            score0, feats0 = model.feats(imgs0)
        maps0 = score0[..., 0].contiguous()

    with phase("kernel A (NMS fixpoint) vs plain fast_nms"):
        blocks, per_sm, threads, smem = cuda_nms.nms_grid(6)
        tiles = PAIRS * (SIZE // 32) ** 2
        log(f"  grid at d=6: {blocks} blocks resident ({per_sm} per SM) of "
            f"{threads} threads, {smem} bytes of dynamic shared memory a "
            f"block; [16,512,512] launches min(blocks, {tiles} tiles) = "
            f"{min(blocks, tiles)}")
        bf = maps0[:1].to(torch.bfloat16)
        cases = [("score maps x8", maps0[:8], 6), ("bf16 ties", bf, 6),
                 ("signed", maps0[-2:] - 0.5, 6),
                 ("score d=2", maps0[:2], 2), ("score d=4", maps0[:2], 4)]
        for name, maps, d in cases:
            stats = torch.zeros(maps.shape[0] + 62, dtype=torch.int32,
                                device=dev)
            before = cuda_nms.KERNEL.launches
            got = cuda_nms.nms_cuda(maps, d, 30, stats=stats)
            n_launch = cuda_nms.KERNEL.launches - before
            want, want_rounds = fast_nms_rounds(maps, d, 30)
            diff = float((got.float() - want.float()).abs().max())
            errs["nms"] = max(errs["nms"], diff)
            ran = stats[:maps.shape[0]]
            log(f"  {name}: equal={torch.equal(got, want)} "
                f"max_abs_err={diff}; launches {n_launch}; rounds per map "
                f"{ran.tolist()} (plain {want_rounds.tolist()})")
            if not (torch.equal(got, want) and n_launch == 1
                    and torch.equal(ran, want_rounds)):
                raise AssertionError(f"kernel A differs on {name}")
        stats = torch.zeros(PAIRS + 62, dtype=torch.int32, device=dev)
        before = cuda_nms.KERNEL.launches
        cuda_nms.nms_cuda(maps0, 6, 30, stats=stats)
        nms_per_call = cuda_nms.KERNEL.launches - before
        _, rounds = fast_nms_rounds(maps0, 6, 30)
        n_r = int(rounds.max()) + 1
        k_mask = stats[PAIRS:PAIRS + n_r].tolist()
        k_supp = stats[PAIRS + 31:PAIRS + 31 + n_r].tolist()
        mask_tiles, supp_tiles, mask_px, supp_px = nms_tile_work(maps0, 6)
        log(f"  [16,512,512] d=6: rounds per map {rounds.tolist()} (kernel "
            f"{stats[:PAIRS].tolist()}); tiles recomputed per round, summed "
            f"over the batch: mask {k_mask}, suppression {k_supp[1:]} "
            f"(the plain run's changed neighbourhoods: {mask_tiles}, "
            f"{supp_tiles[1:]})")
        if not (torch.equal(stats[:PAIRS], rounds) and k_mask == mask_tiles
                and k_supp == supp_tiles and nms_per_call == 1):
            raise AssertionError("kernel A's rounds, recomputed tiles or "
                                 "launches differ from the plain run's")
        nms_ms = cuda_ms(lambda: cuda_nms.nms_cuda(maps0, 6, 30))
        # the rounds a call may run: 0 is round 0 alone; the most any map
        # needs runs all the work of max_iter 30, with nothing after it
        split = {it: cuda_ms(lambda: cuda_nms.nms_cuda(maps0, 6, it))
                 for it in (0, 1, n_r - 1)}
        nms_plain_ms = cuda_ms(lambda: fast_nms(maps0, 6, 30), iters=3,
                               warmup=1)
        nms_full_ms, nms_full_by = nms_bound(maps0, rounds)
        nms_bound_ms, nms_bound_by = nms_change_bound(maps0, mask_px,
                                                      supp_px)
        log(f"  [16,512,512] d=6: kernel {nms_ms:.4f} ms ({nms_per_call} "
            f"launch), by max_iter "
            + ", ".join(f"{it}: {ms:.4f}" for it, ms in split.items())
            + f" ms; plain {nms_plain_ms:.4f} ms, bound {nms_bound_ms:.4f} "
            f"ms ({nms_bound_by}; pixels within d of a change: {mask_px} "
            f"mask, {supp_px} suppression), full-round bound "
            f"{nms_full_ms:.4f} ms ({nms_full_by})")

    with phase("kernel B (sparse sampler) vs plain sampler"):
        with torch.inference_mode():
            kpts0, valid0 = detection_batch(score0, dp)
        px = (kpts0[..., 0] * (SIZE - 1.0)).contiguous()
        py = (kpts0[..., 1] * (SIZE - 1.0)).contiguous()
        order = torch.sort(row_tap_keys(kpts0, SIZE), dim=1, stable=True)[1]
        pxs, pys = px.gather(1, order), py.gather(1, order)
        for name, (x, y) in (("original order", (px, py)),
                             ("y-sorted order", (pxs, pys))):
            got = cuda_sample.sample_cuda(feats0, x, y, SIZE, SIZE)
            want = sample_branches(feats0, x, y, SIZE, SIZE)
            diff = float((got - want).abs().max())
            errs["sample"] = max(errs["sample"], diff)
            log(f"  {name}: max_abs_err={diff:.3g}")
            if not diff <= 1e-5:
                raise AssertionError(f"kernel B differs ({name}): {diff}")
        with torch.inference_mode():
            d_k, k_k, v_k = alike_sparse_descriptors_cm_batch_yorder(
                params, feats0, kpts0, valid0, SIZE, SIZE)
            with plain_twins():
                d_p, k_p, v_p = alike_sparse_descriptors_cm_batch_yorder(
                    params, feats0, kpts0, valid0, SIZE, SIZE)
        diff = float((d_k - d_p).abs().max())
        errs["sample"] = max(errs["sample"], diff)
        log(f"  yorder descriptors: max_abs_err={diff:.3g}")
        if not (diff <= 1e-5 and torch.equal(k_k, k_p)
                and torch.equal(v_k, v_p)):
            raise AssertionError(f"yorder kernel vs plain: {diff}")
        # branches of 3 and 2 rows (a 96^2 or 64^2 image's last branch):
        # the plain twin resizes them densely, the kernel takes its taps
        gen = torch.Generator(device=dev).manual_seed(1)
        for lo in (3, 2):
            sz = 32 * lo
            tiny = tuple(torch.rand((2, 16, sz // r, sz // r), device=dev,
                                    generator=gen) for r in (1, 2, 8, 32))
            tx, ty = (torch.rand((2, 300), device=dev, generator=gen)
                      * (sz - 1) for _ in range(2))
            diff = float((cuda_sample.sample_cuda(tiny, tx, ty, sz, sz)
                          - sample_branches(tiny, tx, ty, sz, sz)).abs().max())
            errs["sample"] = max(errs["sample"], diff)
            log(f"  {sz}^2 branches (last {lo}x{lo}): max_abs_err={diff:.3g}")
            if not diff <= 1e-5:
                raise AssertionError(f"kernel B differs at {sz}^2: {diff}")
        samp_ms = cuda_ms(lambda: cuda_sample.sample_cuda(
            feats0, pxs, pys, SIZE, SIZE))
        samp_plain_ms = cuda_ms(lambda: sample_branches(
            feats0, pxs, pys, SIZE, SIZE), iters=3, warmup=1)
        samp_bound_ms, samp_bound_by = sample_bound(feats0, pxs, pys, SIZE,
                                                    SIZE)
        samp_sector_ms, samp_sector_by, samp_sector_bytes = \
            sample_sector_bound(feats0, pxs, pys, SIZE, SIZE)
        samp_orig_ms = cuda_ms(lambda: cuda_sample.sample_cuda(
            feats0, px, py, SIZE, SIZE))
        log(f"  [16 maps, K={K}]: kernel {samp_ms:.4f} ms y-sorted, "
            f"{samp_orig_ms:.4f} ms original order (CUDA events, "
            f"back-to-back wrapper calls; device time in the next phase), "
            f"plain {samp_plain_ms:.4f} ms, bound {samp_bound_ms:.4f} ms "
            f"({samp_bound_by}; distinct values), sector bound "
            f"{samp_sector_ms:.4f} ms ({samp_sector_by}; "
            f"{samp_sector_bytes} bytes of 32-byte feature sectors)")

    with phase("main path: extract_match, 16 pairs at 512^2"):
        reset_launches()
        n, k0, m1 = extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                 device=DEVICE)
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one extract_match run: {got}")
        launches = {k: got[k] for k in ("nms", "sample")}
        if min(got["nms"], got["sample"], got["nn_match"]) <= 0:
            raise AssertionError(f"a kernel was not launched: {got}")
        if got["nms"] != 2:
            raise AssertionError(f"kernel A: one launch per detection "
                                 f"batch, 2 a step; got {got['nms']}")
        with torch.inference_mode():
            ext_k = [extract(model, params, im, dp) for im in (imgs0, imgs1)]
            with plain_twins():
                ext_p = [extract(model, params, im, dp)
                         for im in (imgs0, imgs1)]
                n_p, k0_p, m1_p = extract_match(model, params, imgs0, imgs1,
                                                dp, 5.0, device=DEVICE)
        for (dk, kk, vk), (dp_, kp, vp) in zip(ext_k, ext_p):
            if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                raise AssertionError("keypoints / masks differ from plain")
        n_valid = int(sum(e[2].sum() for e in ext_k))
        log(f"  matches kernel {int(n)} plain {int(n_p)}; valid keypoints "
            f"{n_valid}; k0 equal {torch.equal(k0, k0_p)}")
        if not torch.equal(k0, k0_p):
            raise AssertionError("k0 differs from the plain-twin pipeline")
        if abs(int(n) - int(n_p)) > 0.005 * n_valid / 2 or int(n) <= 0:
            raise AssertionError(f"match count {int(n)} vs plain {int(n_p)}")
        if not (torch.isfinite(k0).all() and torch.isfinite(m1).all()
                and k0.shape == m1.shape == (PAIRS, K, 3)):
            raise AssertionError("main-path outputs malformed")

        def step():
            return extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                 device=DEVICE)

        windows = timed_windows(step)
        dt = statistics.median(windows)
        fps_all = [2 * PAIRS / w for w in windows]
        log(f"  extract_match: median {dt * 1e3:.3f} ms per 16-pair batch, "
            f"{2 * PAIRS / dt:.2f} frames/s (min {min(fps_all):.2f}, max "
            f"{max(fps_all):.2f}) on {card}")
        with torch.inference_mode():
            st = {"forward (feats, 16 images)":
                  cuda_ms(lambda: model.feats(imgs0), iters=5),
                  "detection_batch (16 maps)":
                  cuda_ms(lambda: detection_batch(score0, dp), iters=5),
                  "yorder descriptors (16 maps)":
                  cuda_ms(lambda: alike_sparse_descriptors_cm_batch_yorder(
                      params, feats0, kpts0, valid0, SIZE, SIZE), iters=5),
                  "mutual_nn_match (16 pairs, kernel D)":
                  cuda_ms(lambda: mutual_nn_match(
                      ext_k[0][0], ext_k[1][0], ext_k[0][2], ext_k[1][2],
                      5.0), iters=5)}
        for name, ms in st.items():
            log(f"  stage {name}: {ms:.4f} ms")
        with torch.inference_mode():
            busy, window, _ = profile_step(lambda: mutual_nn_match(
                ext_k[0][0], ext_k[1][0], ext_k[0][2], ext_k[1][2], 5.0))
        log(f"  stage mutual_nn_match under the profiler: device busy "
            f"{busy:.4f} ms of a {window:.4f} ms window")
        # kernel B's device time of a call (after the timed windows: a
        # process that has profiled once pays more per launch)
        samp_dev = {}
        for name, (x, y) in (("y-sorted", (pxs, pys)),
                             ("original", (px, py))):
            busy, _, _ = profile_step(lambda: [cuda_sample.sample_cuda(
                feats0, x, y, SIZE, SIZE) for _ in range(10)])
            samp_dev[name] = busy / 10
        samp_dev_ms = samp_dev["y-sorted"]
        log(f"  kernel B device time a call: {samp_dev_ms:.4f} ms y-sorted, "
            f"{samp_dev['original']:.4f} ms original order (events "
            f"{samp_ms:.4f} / {samp_orig_ms:.4f}); sector bound "
            f"{samp_sector_ms:.4f} ms, bound {samp_bound_ms:.4f} ms; "
            f"sector bound / device time {samp_sector_ms / samp_dev_ms:.3f}")

    with phase("repeatability: synthetic, 4 pairs at 512^2"):
        cfg = EvalConfig.from_yaml(os.path.join(
            ROOT, "configs", "repeatability_synthetic.yaml"))
        cfg.output_dir = os.path.join(ROOT, "output", "chip_smoke_rep")
        rep = Evaluator(cfg, DEVICE).run()
        with plain_twins():
            rep_p = Evaluator(cfg, DEVICE).run()
        log(f"  repeatability {rep['repeatability']} (plain "
            f"{rep_p['repeatability']}), rep_mean_err {rep['rep_mean_err']}")
        if not (0.0 < rep["repeatability"] <= 1.0
                and rep["per_pair_repeatability"]
                == rep_p["per_pair_repeatability"]):
            raise AssertionError("repeatability out of range or != plain")

    Hs = torch.from_numpy(np.stack(
        [s["warp01_params"]["homography_matrix"] for s in items])).to(dev)
    Hinvs = torch.from_numpy(np.stack(
        [s["warp10_params"]["homography_matrix"] for s in items])).to(dev)
    with torch.inference_mode():
        sk0, sv0, sdm0 = superpoint_detect(sp_model, imgs0, dp)
        sk1, sv1, sdm1 = superpoint_detect(sp_model, imgs1, dp)
        sva, svb = covisible(sk0, sv0, sk1, sv1, Hs, Hinvs, SIZE, SIZE)

    with phase("kernel D (nearest neighbours) vs plain nn_dists"):
        rows = torch.arange(K, device=dev)

        def pen_pair(da, va_, db, vb_):
            # covisibility leaves invalid rows; add more on both sides
            return (penalized(da, va_ & (rows % 9 != 0))[0],
                    penalized(db, vb_ & (rows % 11 != 0))[0])

        gen = torch.Generator(device=dev).manual_seed(3)
        big = [torch.randn((PAIRS, K_LARGE, 256), device=dev, generator=gen)
               for _ in range(2)]
        big = [penalized(x / x.norm(dim=-1, keepdim=True),
                         torch.rand((PAIRS, K_LARGE), device=dev,
                                    generator=gen) > 0.15)[0] for x in big]
        cases = [("SuperPoint D=257",
                  *pen_pair(sample_at_points(sdm0, sk0), sva,
                            sample_at_points(sdm1, sk1), svb)),
                 ("ALIKE-t D=65", *pen_pair(ext_k[0][0], ext_k[0][2],
                                            ext_k[1][0], ext_k[1][2])),
                 (f"random D=257, K={K_LARGE}", *big)]
        for name, a, b in cases:
            got = cuda_match.nn_dists_cuda(a, b)
            want = nn_dists(a, b)
            near, err_free, rel = check_nn(got, want, a, b)
            errs["nn_match"] = max(errs["nn_match"], err_free)
            log(f"  {name} [{a.shape[0]} pairs]: near-tie index differences "
                f"{near[0]} penalty-free, {near[1]} under a penalty, of "
                f"{2 * a.shape[0] * a.shape[1]}; d max abs err "
                f"{err_free:.3g} (penalty-free), {rel:.3g} of scale")
        ints = [torch.randint(-3, 4, (PAIRS, K, 65), device=dev,
                              generator=gen).float() for _ in range(2)]
        if not all(torch.equal(g, w) for g, w in zip(
                cuda_match.nn_dists_cuda(*ints), nn_dists(*ints))):
            raise AssertionError("kernel D differs from the plain twin on "
                                 "integer descriptors")

        def mm_min(a, b):
            """The library calls timed beside kernel D (the port never
            makes them): baddbmm for s, then both minima with indices."""
            def call():
                s = torch.baddbmm((a * a).sum(-1)[..., None]
                                  + (b * b).sum(-1)[:, None, :], a,
                                  b.transpose(1, 2), alpha=-2.0)
                return s.min(-1), s.min(-2)
            return call

        match_t = {}
        for name, a, b in cases:
            ms, lib_ms, turns = in_turns(
                lambda: cuda_match.nn_dists_cuda(a, b), mm_min(a, b),
                iters=20, other_iters=10)
            plain_ms = cuda_ms(lambda: nn_dists(a, b), iters=5)
            bound_ms, bound_by = match_bound(a, b)
            # device time of a call (memset + 2 kernels), which the event
            # time above exceeds where the wrapper's host work paces calls
            busy, _, top = profile_step(
                lambda: [cuda_match.nn_dists_cuda(a, b) for _ in range(10)])
            dev_ms = busy / 10
            by_kernel = ", ".join(f"{k.split('(')[0]} {t / 10:.4f}"
                                  for k, t in top)
            match_t[name] = (ms, plain_ms, lib_ms, bound_ms, bound_by,
                             dev_ms)
            log(f"  {name}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms; "
                f"{by_kernel}), plain "
                f"{plain_ms:.4f} ms, baddbmm + min {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}); bound / device time "
                f"{bound_ms / dev_ms:.3f}; in turns "
                f"kernel, library, library, kernel: "
                f"{[round(t, 4) for t in turns]}")
        (match_ms, match_plain_ms, match_lib_ms, match_bound_ms,
         match_bound_by, match_dev_ms) = match_t["SuperPoint D=257"]
        d65 = match_t["ALIKE-t D=65"]
        big_t = match_t[f"random D=257, K={K_LARGE}"]

    with phase("kernel E (masked attention) vs plain fused_attention"):
        gen = torch.Generator(device=dev).manual_seed(2)

        def qkv(lead, n, m):
            return [torch.randn((*lead, r, 64), device=dev, generator=gen)
                    for r in (n, m, m)]

        def check_e(name, q, k, v, kv, scale=None):
            got = cuda_attention.attention_cuda(q, k, v, kv, scale)
            want = fused_attention(q, k, v, kv, scale)
            err = (got - want).abs()
            bad = err > 1e-5 + 1e-5 * want.abs()
            errs["attention"] = max(errs["attention"], float(err.max()))
            log(f"  {name}: max abs err {float(err.max()):.3g}, outside "
                f"1e-5 abs/rel: {int(bad.sum())}")
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"kernel E differs on {name}")
            return got

        lead = (2 * LG_PAIRS, 4)
        q, k, v = qkv(lead, K, K)
        kv = torch.rand((2 * LG_PAIRS, 1, K), device=dev, generator=gen) > 0.1
        for scale in (None, 1.0):
            check_e(f"[16,4,{K},64] scale {scale or 'dh^-0.5'}", q, k, v, kv,
                    scale)
        got = check_e("all keys invalid", q, k, v, torch.zeros_like(kv))
        if not torch.allclose(got, v.mean(-2, keepdim=True).expand_as(got),
                              atol=1e-5, rtol=1e-5):
            raise AssertionError("all-invalid rows are not uniform")
        q2, k2, v2 = qkv((3, 4), 333, 517)
        check_e("n=333, m=517", q2, k2, v2,
                torch.rand((3, 1, 517), device=dev, generator=gen) > 0.2)

        def sdpa(q, k, v, kv):
            """The library call timed beside kernel E: one
            scaled_dot_product_attention with the additive mask."""
            mask = torch.where(kv, 0.0, -1e9)[..., None, :]
            return lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask)

        att_ms, att_lib_ms, turns = in_turns(
            lambda: cuda_attention.attention_cuda(q, k, v, kv),
            sdpa(q, k, v, kv), iters=20, other_iters=10)
        att_plain_ms = cuda_ms(lambda: fused_attention(q, k, v, kv), iters=5)
        att_bound_ms, att_bound_by, exps = attention_bound(q, K)
        log(f"  [16,4,{K},64]: kernel {att_ms:.4f} ms, plain "
            f"{att_plain_ms:.4f} ms, sdpa {att_lib_ms:.4f} ms, bound "
            f"{att_bound_ms:.4f} ms ({att_bound_by}), {exps} exps; in turns "
            f"kernel, sdpa, sdpa, kernel: {[round(t, 4) for t in turns]}")
        got = cuda_attention.attention_cuda(q, k, v,
                                            cuda_attention.head_mask(kv[:, 0],
                                                                     4))
        if not torch.equal(got, cuda_attention.attention_cuda(q, k, v, kv)):
            raise AssertionError("head_mask changes kernel E's result")

    for matcher, pairs in (("brute_force", PAIRS), ("light_glue", LG_PAIRS)):
        with phase(f"superpoint_mha_step: {matcher}, {pairs} pairs at "
                   f"{SIZE}^2"):
            lgp = lg_params if matcher == "light_glue" else None
            args = (sp_model, imgs0[:pairs], imgs1[:pairs], Hs[:pairs],
                    Hinvs[:pairs], dp)

            def step(seed=0):
                return superpoint_mha_step(
                    *args, torch.Generator(device=dev).manual_seed(seed),
                    matcher, lgp, 5.0, 512, device=DEVICE)

            reset_launches()
            hits, m0, m1, ok = step()
            torch.cuda.synchronize()
            got = read_launches()
            need = "nn_match" if matcher == "brute_force" else "attention"
            log(f"  launches in one run: {got}")
            if got["nms"] <= 0 or got[need] <= 0:
                raise AssertionError(f"a kernel was not launched: {got}")
            launches[need] = got[need]
            with plain_twins():
                hits_p, m0_p, m1_p, ok_p = step()
            n_valid = int(sv0[:pairs].sum() + sv1[:pairs].sum())
            n_ok, n_ok_p = int(ok.sum()), int(ok_p.sum())
            rows_differ = int((ok != ok_p).sum() + (
                ok & ok_p & (m1 != m1_p).any(-1)).sum())
            hit_diff = int((hits != hits_p).any(-1).sum())
            log(f"  matches kernel {n_ok} plain {n_ok_p} of {n_valid} valid "
                f"keypoints; rows that differ {rows_differ}; MHA@3/5/7 "
                f"kernel {hits.mean(0).tolist()} plain "
                f"{hits_p.mean(0).tolist()}; pairs whose hits differ "
                f"{hit_diff}")
            if not (torch.equal(m0, m0_p) and hits.shape == (pairs, 3)
                    and bool(torch.isfinite(m1).all())
                    and bool(((hits == 0) | (hits == 1)).all())):
                raise AssertionError("MHA step outputs malformed or "
                                     "keypoints differ from plain")
            if abs(n_ok - n_ok_p) > 0.005 * n_valid / 2:
                raise AssertionError(f"match count {n_ok} vs plain {n_ok_p}")

            with torch.inference_mode():
                heat0, _ = sp_model(imgs0[:pairs])
                k0_, v0_, dm0_ = sk0[:pairs], sva[:pairs], sdm0[:pairs]
                k1_, v1_, dm1_ = sk1[:pairs], svb[:pairs], sdm1[:pairs]
                mk0, mk1, mok = match_pairs(matcher, k0_, v0_, k1_, v1_,
                                            dm0_, dm1_, SIZE, SIZE, 5.0, lgp)
                if matcher == "light_glue":
                    p0 = k0_[..., :2] * (SIZE - 1.0)
                    p1 = k1_[..., :2] * (SIZE - 1.0)
                    lg_in = (p0, v0_, sample_descriptors_lg(p0, dm0_, 8),
                             p1, v1_, sample_descriptors_lg(p1, dm1_, 8))
                    sc = {}
                    for n_layers in (2, 9):
                        sc[n_layers] = lightglue_scores(lg_params, *lg_in,
                                                        n_layers=n_layers)
                        with plain_twins():
                            sc[n_layers] = (sc[n_layers], lightglue_scores(
                                lg_params, *lg_in, n_layers=n_layers))
                    rel2 = close_scores(*sc[2])
                    live = sc[9][1] > -1e8
                    rel9 = float((sc[9][0] - sc[9][1])[live].norm()
                                 / sc[9][1][live].norm())
                    log(f"  LightGlue scores vs plain twins: 2 layers "
                        f"{rel2:.3g}, 9 layers {rel9:.3g} (relative norm)")
            windows = timed_windows(step)
            dt = statistics.median(windows)
            pps = [pairs / w for w in windows]
            log(f"  step: median {dt * 1e3:.3f} ms per {pairs}-pair batch, "
                f"{pairs / dt:.2f} pairs/s (min {min(pps):.2f}, max "
                f"{max(pps):.2f}) on {card}")
            gen_t = torch.Generator(device=dev).manual_seed(0)
            with torch.inference_mode():
                st = {f"forward, SuperPoint on {pairs} images":
                      cuda_ms(lambda: sp_model(imgs0[:pairs]), iters=5),
                      f"detection_batch, {pairs} maps":
                      cuda_ms(lambda: detection_batch(heat0, dp), iters=5),
                      "covisibility warp":
                      cuda_ms(lambda: covisible(k0_, sv0[:pairs], k1_,
                                                sv1[:pairs], Hs[:pairs],
                                                Hinvs[:pairs], SIZE, SIZE),
                              iters=5),
                      f"match: {matcher}":
                      cuda_ms(lambda: match_pairs(
                          matcher, k0_, v0_, k1_, v1_, dm0_, dm1_, SIZE,
                          SIZE, 5.0, lgp), iters=5),
                      "RANSAC-H + MHA":
                      cuda_ms(lambda: mha_pair(mk0, mk1, mok, Hs[:pairs],
                                               SIZE, SIZE, SIZE, SIZE,
                                               gen_t), iters=5)}
            for name, ms in st.items():
                log(f"  stage {name}: {ms:.4f} ms")
            busy, window, top = profile_step(step)
            log(f"  profiled step: device busy {busy:.3f} ms of a "
                f"{window:.3f} ms window, idle share "
                f"{1.0 - busy / window:.4f}" if window > 0 else
                "  profiled step: no events recorded")
            for name, ms in top:
                log(f"    device time {ms:.4f} ms: {name[:90]}")

    with phase("MHA runner: SuperPoint + light_glue, 4 pairs at 512^2"):
        cfg = EvalConfig(
            model_type="SuperPoint", task_type="MHA",
            data_params={"type": "synthetic_homography", "num_pairs": 4,
                         "image_size": SIZE},
            extractor_params={"nms_dist": 6, "border_dist": 8, "top_k": K,
                              "threshold": 0, "min_score": 0.0},
            matcher_params={"type": "light_glue"},
            task_params={"th": [3, 5, 7]},
            weights_dir=stage_golden_weights(os.path.join(
                ROOT, "output", "chip_smoke_weights")),
            output_dir=os.path.join(ROOT, "output", "chip_smoke_mha"))
        reset_launches()
        res = Evaluator(cfg, DEVICE).run()
        got = read_launches()
        with plain_twins():
            res_p = Evaluator(cfg, DEVICE).run()
        log(f"  MHA@3/5/7 {[res[f'MHA@{t}'] for t in (3, 5, 7)]} (plain "
            f"{[res_p[f'MHA@{t}'] for t in (3, 5, 7)]}); launches {got}")
        if got["attention"] <= 0 or got["nn_match"] != 0:
            raise AssertionError(f"the runner missed kernel E: {got}")
        if res["per_pair"] != res_p["per_pair"]:
            raise AssertionError("MHA runner differs from the plain twins")

    with phase(f"kernel E alone at K={K_LARGE}"):
        q4, k4, v4 = qkv(lead, K_LARGE, K_LARGE)
        kv4 = torch.rand((2 * LG_PAIRS, 1, K_LARGE), device=dev,
                         generator=gen) > 0.1
        check_e(f"[16,4,{K_LARGE},64]", q4, k4, v4, kv4)
        att4_ms, att4_lib_ms, turns = in_turns(
            lambda: cuda_attention.attention_cuda(q4, k4, v4, kv4),
            sdpa(q4, k4, v4, kv4), iters=3, other_iters=3)
        att4_plain_ms = cuda_ms(lambda: fused_attention(q4, k4, v4, kv4),
                                iters=2, warmup=1)
        att4_bound_ms, _, _ = attention_bound(q4, K_LARGE)
        log(f"  [16,4,{K_LARGE},64]: kernel {att4_ms:.4f} ms, plain "
            f"{att4_plain_ms:.4f} ms, sdpa {att4_lib_ms:.4f} ms, bound "
            f"{att4_bound_ms:.4f} ms; in turns kernel, sdpa, sdpa, kernel: "
            f"{[round(t, 4) for t in turns]}")
        # named here and not beside the first timing: the first profiled
        # call attaches the tracer, and every launch after it costs the
        # host more, which the brute-force step above should not pay
        call = sdpa(q, k, v, kv)
        _, _, top = profile_step(lambda: [call() for _ in range(5)], top=3)
        for name, ms in top:
            log(f"  sdpa's device kernels at K={K}, {ms / 5:.4f} ms a call: "
                f"{name[:110]}")
        if not top:
            raise AssertionError("the profiler named no device kernel of "
                                 "scaled_dot_product_attention")
        del q4, k4, v4

    lk = LKParams(distance=10.0, win_size=21, levels=3, iterations=40)
    with phase(f"data: {LK_PAIRS} consecutive-frame pairs of the synthetic "
               f"sequence at {SIZE}^2"):
        seq = SyntheticSequenceDataset(LK_PAIRS + 1, SIZE, 0)
        frames = torch.from_numpy(np.stack(
            [seq[i]["image0"] for i in range(LK_PAIRS + 1)])).to(dev)
        lk_imgs0, lk_imgs1 = frames[:-1].contiguous(), frames[1:].contiguous()
        lk_Fs = torch.from_numpy(seq.Fs[1:]).to(dev)
        with torch.inference_mode():
            lk_score, _ = model(lk_imgs0)
            lk_k0, lk_v0 = detection_batch(lk_score, dp)
        pyr0 = [lk_imgs0] + [_avg_pool_img(lk_imgs0, k) for k in (2, 4)]
        pyr1 = [lk_imgs1] + [_avg_pool_img(lk_imgs1, k) for k in (2, 4)]
        px_full = lk_k0[..., 0:2] * (SIZE - 1.0)

    with phase("kernel F (LK level) vs plain _lk_level"):
        gen = torch.Generator(device=dev).manual_seed(3)
        lk_loose_err = 0.0
        for win in (21, 3):
            for lvl in range(3):
                hl = SIZE // 2 ** lvl
                starts = {"keypoints": px_full / 2 ** lvl,
                          "border points": border_points(LK_PAIRS, K, hl, hl,
                                                         gen, dev)}
                for name, pts1 in starts.items():
                    pts2 = pts1 + (torch.rand(pts1.shape, generator=gen,
                                              device=dev) * 4 - 2)
                    args = (pyr0[lvl], pyr1[lvl], pts1, pts2, win, 8)
                    got = cuda_lk.lk_level_cuda(*args)
                    want = _lk_level(*args)
                    e = (got - want).abs().amax(-1)
                    n_out = int((e > 5e-3).sum())
                    err = float(e.max())
                    # a 3 x 3 window that hangs over the border of the
                    # smoothed block texture sees next to no gradient: the
                    # system is near-singular, rounding decides the step,
                    # and a few such points may end elsewhere
                    loose = win == 3 and name == "border points"
                    if loose:
                        lk_loose_err = max(lk_loose_err, err)
                    else:
                        errs["lk"] = max(errs["lk"], err)
                    log(f"  win {win} level {lvl} ({hl}^2) {name}: max abs "
                        f"err {err:.3g} px; beyond 5e-3 px: {n_out} of "
                        f"{e.numel()}")
                    if n_out:
                        det = lk_det(pyr1[lvl], want, win)
                        for bi, ni in (e > 5e-3).nonzero()[:5].tolist():
                            log(f"    pair {bi} point {ni}: "
                                f"{float(e[bi, ni]):.3g} px apart, det at "
                                f"the plain run's end {float(det[bi, ni]):.3g}")
                    if (n_out > (0.005 * e.numel() if loose else 0)
                            or not bool(torch.isfinite(got).all())):
                        raise AssertionError(f"kernel F differs: win {win} "
                                             f"level {lvl} {name}: {err}")
        angles = draw_angles((LK_PAIRS, K), gen, dev)
        flow_args = (lk_imgs0, lk_imgs1, lk_k0, lk_k0, angles, lk)
        got, _ = optical_flow_batch_from_angles(*flow_args)
        with plain_twins():
            want, _ = optical_flow_batch_from_angles(*flow_args)
        d = (got - want).abs().amax(-1) * (SIZE - 1.0)
        share = float((d <= 1e-2).float().mean())
        log(f"  full protocol (3 levels x 40 iterations, distance 10): "
            f"{share:.4%} of {d.numel()} points within 1e-2 px of the plain "
            f"run; median {float(d.median()):.3g} px")
        far = (d > 1e-2).nonzero()[:12]
        dets = lk_det(lk_imgs1, want * (SIZE - 1.0), lk.win_size)
        for bi, ni in far.tolist():
            log(f"    pair {bi} point {ni}: {float(d[bi, ni]):.3g} px apart, "
                f"det {float(dets[bi, ni]):.3g}, valid "
                f"{bool(lk_v0[bi, ni])}")
        if share < 0.99:
            raise AssertionError(f"kernel F full protocol: {share}")
        jit = torch.stack([torch.cos(angles), torch.sin(angles)], -1)
        start = (px_full + jit * lk.distance).clamp(10, SIZE - 10)
        # each level from the start the protocol gives it (the level
        # above's result): the kernel's time depends on how far a point
        # still has to go, since it loads a window only when its start moves
        lk_plain_ms, lk_level_ms, lk_turns, lk_loads = 0.0, [], [], []
        for lvl in (2, 1, 0):
            args = (pyr0[lvl], pyr1[lvl], px_full / 2 ** lvl,
                    start / 2 ** lvl, lk.win_size, lk.iterations)
            moves = torch.zeros(1, dtype=torch.int32, device=dev)
            start = cuda_lk.lk_level_cuda(*args, moves=moves) * 2 ** lvl
            lk_loads.append(int(moves.item()))
            ms, plain, turns = in_turns(
                lambda: cuda_lk.lk_level_cuda(*args),
                lambda: _lk_level(*args), iters=5, other_iters=1)
            lk_level_ms.append(ms)
            lk_turns.append([round(t, 4) for t in turns])
            lk_plain_ms += plain
        lk_ms = sum(lk_level_ms)
        lk_bound_ms, lk_bound_by, pt_iters, lk_bound_every_ms = lk_bound(
            lk_imgs0, K, lk.win_size, lk.levels, lk.iterations)
        per_level = LK_PAIRS * K * lk.iterations
        # the first iteration of a point always loads; the rest only when
        # the window's integer start moved
        moved = [(n_ - LK_PAIRS * K) / (per_level - LK_PAIRS * K)
                 for n_ in lk_loads]
        lk_moved_share = (sum(lk_loads) - lk.levels * LK_PAIRS * K) / (
            lk.levels * (per_level - LK_PAIRS * K))
        log(f"  [{LK_PAIRS} pairs, K={K}, win {lk.win_size}, "
            f"{lk.iterations} iterations] levels /4, /2, /1: "
            f"kernel {[round(t, 4) for t in lk_level_ms]} ms, sum "
            f"{lk_ms:.4f} ms ({lk_ms * 1e6 / pt_iters:.2f} ns per "
            f"point-iteration), plain {lk_plain_ms:.4f} ms, bound "
            f"{lk_bound_ms:.4f} ms ({lk_bound_by}; "
            f"{lk_bound_every_ms:.4f} ms with the gradients counted in "
            f"every iteration)")
        log(f"  in turns kernel, plain, plain, kernel per level: {lk_turns}")
        log(f"  window loads per level {lk_loads} of {per_level} "
            f"point-iterations; share of the iterations after a point's "
            f"first whose window start moved: "
            f"{[round(m_, 5) for m_ in moved]}, all levels "
            f"{lk_moved_share:.5f}")

    with phase(f"lk_fundamental_step: {LK_PAIRS} pairs at {SIZE}^2"):
        def lk_step(seed=0):
            return lk_fundamental_step(
                model, params, lk_imgs0, lk_imgs1, lk_Fs,
                torch.Generator(device=dev).manual_seed(seed), dp, lk,
                device=DEVICE)

        reset_launches()
        out, k0, v0, tracked = lk_step()
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one lk_fundamental_step run: {got}")
        if got["nms"] <= 0 or got["lk"] != lk.levels:
            raise AssertionError(f"a kernel was not launched: {got}")
        launches["lk"] = got["lk"]
        with plain_twins():
            out_p, k0_p, v0_p, tracked_p = lk_step()
        n_valid = v0.sum(-1)
        err, err_p = out["fundamental_error"], out_p["fundamental_error"]
        num, num_p = out["fundamental_num"], out_p["fundamental_num"]
        log(f"  fundamental_error per pair {[round(x, 5) for x in err.tolist()]}"
            f" (plain {[round(x, 5) for x in err_p.tolist()]}); "
            f"fundamental_num {num.tolist()} (plain {num_p.tolist()}) of "
            f"{n_valid.tolist()} valid keypoints; radio "
            f"{[round(x, 4) for x in out['fundamental_radio'].tolist()]}")
        if not (torch.equal(k0, k0_p) and torch.equal(v0, v0_p)
                and torch.equal(k0, lk_k0)):
            raise AssertionError("keypoints differ from the plain-twin step")
        if not (bool(torch.isfinite(tracked).all())
                and tracked.shape == (LK_PAIRS, K, 2)
                and bool(torch.isfinite(err).all()) and int(num.min()) > 0):
            raise AssertionError("lk_fundamental_step outputs malformed")
        if not bool(((err - err_p).abs() <= 1e-3 * err_p.abs()).all()):
            raise AssertionError("fundamental_error differs from plain by "
                                 "more than 1e-3 relative")
        if not bool(((num - num_p).abs() <= 0.005 * n_valid).all()):
            raise AssertionError("fundamental_num differs from plain")

        windows = timed_windows(lk_step)
        dt = statistics.median(windows)
        lk_fps = LK_PAIRS / dt
        fps_all = [LK_PAIRS / w for w in windows]
        log(f"  lk_fundamental_step: median {dt * 1e3:.3f} ms per "
            f"{LK_PAIRS}-pair batch, {lk_fps:.2f} frames/s (min "
            f"{min(fps_all):.2f}, max {max(fps_all):.2f}) on {card}")
        scale = torch.tensor([SIZE - 1.0, SIZE - 1.0], device=dev)
        with torch.inference_mode():
            st = {f"forward, ALIKE-t on {LK_PAIRS} images":
                  cuda_ms(lambda: model(lk_imgs0), iters=5),
                  f"detection_batch, {LK_PAIRS} maps":
                  cuda_ms(lambda: detection_batch(lk_score, dp), iters=5),
                  "pyramids (avg pool /2 and /4 of 16 images)":
                  cuda_ms(lambda: [_avg_pool_img(im, k) for im in
                                   (lk_imgs0, lk_imgs1) for k in (2, 4)],
                          iters=5),
                  "LK level /4 (kernel F)": lk_level_ms[0],
                  "LK level /2 (kernel F)": lk_level_ms[1],
                  "LK level /1 (kernel F)": lk_level_ms[2],
                  "fundamental_metrics":
                  cuda_ms(lambda: fundamental_metrics(
                      k0[..., 0:2] * scale, tracked * scale, v0, lk_Fs),
                      iters=5)}
        for name, ms in st.items():
            log(f"  stage {name}: {ms:.4f} ms")
        busy, window, top = profile_step(lk_step)
        log(f"  profiled step: device busy {busy:.3f} ms of a "
            f"{window:.3f} ms window, idle share "
            f"{1.0 - busy / window:.4f}" if window > 0 else
            "  profiled step: no events recorded")
        for name, ms in top:
            log(f"    device time {ms:.4f} ms: {name[:90]}")

    with phase("kernel C (peel) vs plain peel_topk; fused detection"):
        nms16 = cuda_nms.nms_cuda(maps0, dp.nms_dist, 30)
        # three distinct bf16 values: far more than top_k maxima tie at the
        # top, so some chunk's eighth candidate still reaches the cutoff
        ties = (torch.round(torch.rand((2, SIZE, SIZE), device=dev,
                                       generator=gen) * 2) / 2).to(
            torch.bfloat16)
        cases = [("NMS'd score maps x16", nms16),
                 ("tie-heavy", cuda_nms.nms_cuda(ties, 2, 30).float()),
                 ("sparse", torch.where(nms16[:2] > 0.6, nms16[:2], 0.0))]
        for name, m in cases:
            v, i = cuda_nms.peel_cuda(m, dp.border_dist, 8)
            pv, pi = peel_topk(m, dp.border_dist, 8)
            diff = float((v - pv).abs().nan_to_num(0.0).max())
            errs["peel"] = max(errs["peel"], diff)
            short = int(((m != 0).reshape(*m.shape[:2], -1, 128).sum(-1)
                         < 8).sum())
            log(f"  {name}: values equal={torch.equal(v, pv)} indices "
                f"equal={torch.equal(i, pi)}; chunks with fewer than 8 "
                f"non-zero entries: {short}")
            if not (torch.equal(v, pv) and torch.equal(i, pi)):
                raise AssertionError(f"kernel C differs on {name}")
        reset_launches()
        with torch.inference_mode():
            fk, fv = detection_batch_fused(score0, dp)
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  launches in one detection_batch_fused run: {got}")
        if got["nms"] <= 0 or got["peel"] != 1:
            raise AssertionError(f"a kernel was not launched: {got}")
        launches["peel"] = got["peel"]
        tie_dp = DetectParams(nms_dist=2, border_dist=8, top_k=K)
        with torch.inference_mode():
            for name, maps, p_, want_unsafe in (
                    ("score maps x16", maps0, dp, False),
                    ("tie-heavy", ties, tie_dp, True)):
                fk, fv = detection_batch_fused(maps, p_)
                pk, pv = detection_batch(maps, p_)
                unsafe = fused_topk(maps, p_, K)[2]
                log(f"  detection_batch_fused on {name}: keypoints equal="
                    f"{torch.equal(fk, pk)} masks equal="
                    f"{torch.equal(fv, pv)} full-sort guard taken={unsafe}")
                if not (torch.equal(fk, pk) and torch.equal(fv, pv)
                        and unsafe == want_unsafe):
                    raise AssertionError(f"fused detection on {name}")
            peel_ms = cuda_ms(lambda: cuda_nms.peel_cuda(nms16, 8, 8))
            peel_plain_ms = cuda_ms(lambda: peel_topk(nms16, 8, 8), iters=5)
            # the library yardstick: torch.topk of every 128-column chunk
            # of the same border-masked maps (values only: topk does not
            # promise kernel C's lowest-index order on ties)
            masked = remove_border(nms16.float(), dp.border_dist)
            pb, ph, pw = masked.shape

            def chunk_topk():
                return torch.topk(masked.view(pb, ph, pw // 128, 128), 8,
                                  dim=-1)

            if not torch.equal(chunk_topk()[0].reshape(pb, ph, -1),
                               cuda_nms.peel_cuda(nms16, 8, 8)[0]):
                raise AssertionError("torch.topk's values differ from "
                                     "kernel C's")
            peel_turn_ms, topk_ms, peel_turns = in_turns(
                lambda: cuda_nms.peel_cuda(nms16, 8, 8), chunk_topk,
                iters=20, other_iters=20)
            det_fused_ms, det_ms, det_turns = in_turns(
                lambda: detection_batch_fused(score0, dp),
                lambda: detection_batch(score0, dp), iters=5, other_iters=5)
        peel_bound_ms, peel_bound_by = peel_bound(nms16, 8)
        log(f"  {list(nms16.shape)} per_chunk 8: kernel {peel_ms:.4f} ms, plain "
            f"{peel_plain_ms:.4f} ms, bound {peel_bound_ms:.4f} ms "
            f"({peel_bound_by}); torch.topk of the chunks {topk_ms:.4f} ms "
            f"in turns with the kernel's {peel_turn_ms:.4f} (kernel, topk, "
            f"topk, kernel: {[round(t, 4) for t in peel_turns]}); "
            f"detection_batch {det_ms:.4f} ms, "
            f"detection_batch_fused {det_fused_ms:.4f} ms; in turns fused, "
            f"unfused, unfused, fused: {[round(t, 4) for t in det_turns]}")

    with phase("FundamentalMatrix runner: optical_flow, 5 frames at 512^2"):
        for pipelined in (False, True):
            cfg = EvalConfig.from_yaml(os.path.join(
                ROOT, "configs", "fund_synthetic.yaml"))
            cfg.data_params = {**cfg.data_params, "num_frames": 5,
                               "image_size": SIZE}
            cfg.task_params = {**cfg.task_params, "pipelined": pipelined}
            cfg.output_dir = os.path.join(ROOT, "output", "chip_smoke_fund")
            reset_launches()
            res = Evaluator(cfg, DEVICE).run()
            got = read_launches()
            with plain_twins():
                res_p = Evaluator(cfg, DEVICE).run()
            e, e_p = (np.asarray(r["per_frame_error"]) for r in (res, res_p))
            log(f"  pipelined={pipelined}: per_frame_error "
                f"{np.round(e, 5).tolist()} (plain "
                f"{np.round(e_p, 5).tolist()}); fundamental_num "
                f"{res['fundamental_num']} (plain {res_p['fundamental_num']})"
                f"; launches {got}")
            want_lk = lk.levels * (1 if pipelined else 5)
            if got["lk"] != want_lk or got["nms"] <= 0:
                raise AssertionError(f"the runner missed kernel F: {got}")
            if not (np.isfinite(e).all() and len(e) == 5
                    and (np.abs(e - e_p) <= 1e-3 * np.abs(e_p) + 1e-5).all()
                    and abs(res["fundamental_num"] - res_p["fundamental_num"])
                    <= 0.005 * K):
                raise AssertionError("FundamentalMatrix runner differs from "
                                     "the plain twins")

    kernels = [
        {"name": "nms_fixpoint", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/nms.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_nms.py:87",
         "launches": launches["nms"], "max_abs_err": errs["nms"],
         "ms": nms_ms, "plain_ms": nms_plain_ms, "bound_ms": nms_bound_ms,
         "bound_by": nms_bound_by, "library_ms": None,
         "bound_ms_full_rounds": nms_full_ms,
         "launches_per_call": nms_per_call,
         "ms_by_max_iter": {str(it): ms for it, ms in split.items()},
         "grid_blocks": min(blocks, tiles), "tiles_mask_per_round": k_mask,
         "tiles_suppression_per_round": k_supp[1:]},
        {"name": "sparse_sample", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/sample.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_sample.py:107",
         "launches": launches["sample"], "max_abs_err": errs["sample"],
         "ms": samp_ms, "plain_ms": samp_plain_ms, "bound_ms": samp_bound_ms,
         "bound_by": samp_bound_by, "library_ms": None,
         "device_ms": samp_dev_ms, "ms_original_order": samp_orig_ms,
         "device_ms_original_order": samp_dev["original"],
         "sector_bound_ms": samp_sector_ms,
         "sector_bound_by": samp_sector_by},
        {"name": "nn_match", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/match.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_match.py:29",
         "launches": launches["nn_match"], "max_abs_err": errs["nn_match"],
         "ms": match_ms, "plain_ms": match_plain_ms,
         "bound_ms": match_bound_ms, "bound_by": match_bound_by,
         "library_ms": match_lib_ms, "device_ms": match_dev_ms,
         "ms_d65": d65[0], "device_ms_d65": d65[5], "plain_ms_d65": d65[1],
         "library_ms_d65": d65[2], "bound_ms_d65": d65[3],
         f"ms_k{K_LARGE}": big_t[0], f"device_ms_k{K_LARGE}": big_t[5],
         f"library_ms_k{K_LARGE}": big_t[2],
         f"bound_ms_k{K_LARGE}": big_t[3]},
        {"name": "attention", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/attention.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_attention.py:33",
         "launches": launches["attention"],
         "max_abs_err": errs["attention"], "ms": att_ms,
         "plain_ms": att_plain_ms, "bound_ms": att_bound_ms,
         "bound_by": att_bound_by, "library_ms": att_lib_ms,
         f"ms_k{K_LARGE}": att4_ms, f"plain_ms_k{K_LARGE}": att4_plain_ms,
         f"library_ms_k{K_LARGE}": att4_lib_ms,
         f"bound_ms_k{K_LARGE}": att4_bound_ms},
        {"name": "lk_level", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/lk.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_lk.py:78",
         "launches": launches["lk"], "max_abs_err": errs["lk"],
         "ms": lk_ms, "plain_ms": lk_plain_ms, "bound_ms": lk_bound_ms,
         "bound_by": lk_bound_by, "library_ms": None,
         "bound_ms_gradients_every_iteration": lk_bound_every_ms,
         "window_loads_per_level": lk_loads,
         "moved_start_share": lk_moved_share,
         "max_abs_err_win3_border": lk_loose_err,
         "ms_per_level": lk_level_ms, "step_frames_per_s": lk_fps},
        {"name": "peel_topk", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/peel.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_nms.py:127",
         "launches": launches["peel"], "max_abs_err": errs["peel"],
         "ms": peel_ms, "plain_ms": peel_plain_ms, "bound_ms": peel_bound_ms,
         "bound_by": peel_bound_by, "library_ms": topk_ms,
         "ms_in_turns_with_library": peel_turn_ms,
         "detection_batch_ms": det_ms,
         "detection_batch_fused_ms": det_fused_ms},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
