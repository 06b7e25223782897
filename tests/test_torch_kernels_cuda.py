"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

Marked `cuda`: they skip on a host without a GPU. On the card run
`python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py`. This file
imports torch only (the card's machine has no JAX).

Tolerances: kernel A (NMS) is bit-exact, and runs each map for as many
rounds as the plain fixpoint, in one launch; kernel B (sampler) within 1e-5
absolute of the plain gather (f32 sums of the same products, another
order). Kernel D (nearest neighbours): on integer descriptors every
distance is exact, so indices and distances are equal, ties included; on
float descriptors indices are equal except at near ties (the two
candidates' distances within 1e-5 of |a|^2 + |b|^2) and distances agree
within 1e-5 of that scale. Kernel E (attention) within 1e-5 absolute and
relative of the plain twin (online softmax, another summation order).
Kernel F (one LK level) within 5e-3 px of the plain `_lk_level` after 8
iterations (another summation order of the five sums, amplified by the
Gauss-Newton steps; the JAX package's tolerance between its kernel and
`_lk_level`). The BatchNorm epilogue (csrc/bn_epilogue.cu) gives the bits
of its plain twin, `models/common.py` `bn_chain` run on the card (NaN
matching NaN; -0.0 and +0.0 differ), and so do whole forwards through it,
against the forwards as they ran before it (conv biases in the conv) and
exported. Kernel C (the peel) only compares and selects: values equal
under == (NaN matching NaN; -0.0 ties with +0.0, as the reference's == has
it), equal indices. `vo_step` on the card against its plain-twin run on
the same generator seed: keypoints equal, match rows within 0.5% of the
valid keypoints, and where the matches are equal the positions within
1e-3 of the trajectory's length. `ba_solve` on the card against the CPU
on one problem: the mean error within 1e-3 px in float32 and 1e-6 px in
float64, poses within 1e-3 and 1e-6 after the free scale about camera 0
(`chip_smoke.gauge_gap`).

bf16 mode: kernel B's bf16 instantiation within 1e-5 of the largest
output of the plain bf16 sampler (the same rounded column weights, f32
sums in another order); bf16 descriptors reach kernel D upcast, as the
CPU path takes them.
"""
import os
import runpy

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from keypoint_bench_tpu_torch.models import common as tcommon
from keypoint_bench_tpu_torch.models import lightglue as tlg
from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_bn, cuda_lk,
                                          cuda_match, cuda_nms, cuda_sample)
from keypoint_bench_tpu_torch.ops import lk as tlk
from keypoint_bench_tpu_torch.ops.attention import fused_attention
from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                 detection_batch,
                                                 detection_batch_fused,
                                                 fast_nms, fast_nms_rounds,
                                                 fused_topk, peel_topk)
from keypoint_bench_tpu_torch.ops.matching import (mutual_nn_fused,
                                                   mutual_nn_match, nn_dists)
from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
from keypoint_bench_tpu_torch.weights import load_golden_params
from keypoint_bench_tpu_torch.weights.io import GOLDEN_DIR
from test_torch_bn_epilogue import same_bits

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _maps(kind, shape, seed):
    rng = np.random.default_rng(seed)
    m = rng.random(shape).astype(np.float32)
    if kind != "random":
        m = ndi.gaussian_filter(m, (0, 2.0, 2.0)).astype(np.float32)
    if kind == "signed":
        m = m - 0.5
    t = torch.from_numpy(m)
    if kind == "ties_bf16":
        t = (torch.round(t * 8) / 8).to(torch.bfloat16)
    return t


@pytest.mark.parametrize("d", [1, 2, 4, 6, 16])
@pytest.mark.parametrize("kind", ["random", "smooth", "ties_bf16", "signed"])
def test_nms_kernel_bit_exact(dev, kind, d):
    maps = _maps(kind, (3, 100, 130), d)
    got = cuda_nms.nms_cuda(maps.to(dev), d, 30)
    want = fast_nms(maps.to(dev), d, 30)
    assert got.dtype == maps.dtype
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), fast_nms(maps, d, 30))


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_nms_kernel_respects_max_iter(dev, max_iter):
    maps = _maps("smooth", (2, 64, 96), 7).to(dev)
    assert torch.equal(cuda_nms.nms_cuda(maps, 4, max_iter),
                       fast_nms(maps, 4, max_iter))


def _blurred(shape, sigma, seed):
    """Noise blurred by a Gaussian of `sigma` px: at d = 2, sigma 4 takes
    20-30 rounds, each map its own number."""
    m = np.random.default_rng(seed).random(shape).astype(np.float32)
    return torch.from_numpy(ndi.gaussian_filter(m, (0, sigma, sigma)).astype(
        np.float32))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _nms_cases():
    ties = (torch.round(torch.from_numpy(np.random.default_rng(9).random(
        (2, 160, 224)).astype(np.float32)) * 2) / 2).to(torch.bfloat16)
    return {
        "100x130": (_blurred((3, 100, 130), 2, 1), 6, 30),
        "352x1216": (_blurred((2, 352, 1216), 2, 2), 4, 30),
        "d1": (_blurred((2, 96, 128), 2, 3), 1, 30),
        "d16": (_blurred((2, 160, 200), 2, 4), 16, 30),
        "max_iter0": (_blurred((2, 96, 160), 4, 5), 2, 0),
        "max_iter1": (_blurred((2, 96, 160), 4, 5), 2, 1),
        "max_iter2": (_blurred((2, 96, 160), 4, 5), 2, 2),
        "rounds_differ": (_blurred((6, 256, 256), 4, 6), 2, 30),
        "beyond_grid": (_blurred((24, 512, 512), 4, 7), 2, 30),
        "constant": (torch.full((2, 200, 200), 0.25), 6, 30),
        "ties_bf16": (ties, 2, 30),
        "nan": (_with_nan(_blurred((3, 128, 160), 2, 8)), 4, 30)}


def _with_nan(maps):
    """sfd2's randomized golden weights overflow its exp-normalized head
    to NaN on about half of the pixels: scattered NaNs and a NaN block."""
    rng = np.random.default_rng(10)
    maps = maps.clone()
    maps[torch.from_numpy(rng.random(maps.shape) < 0.05)] = float("nan")
    maps[:, 40:70, 90:130] = float("nan")
    return maps


@pytest.mark.parametrize("case", sorted(_nms_cases()))
def test_nms_kernel_bit_equal_per_map_rounds(dev, case):
    """Bit equality with fast_nms, one launch, and the rounds the kernel
    ran for each map equal to fast_nms_rounds': maps off the 32-pixel
    tiles, d = 1 and 16, max_iter cutting maps that still change, maps
    stopping in different rounds, more tiles (24 x 256) than the resident
    grid holds blocks, on maps that need 20-30 rounds (values other blocks
    wrote before a grid barrier must be read fresh), a constant map and a
    tie-heavy bf16 map, and maps with NaNs (a window holding one has no
    local maximum; NaN pixels keep their bits)."""
    maps, d, max_iter = _nms_cases()[case]
    maps = maps.to(dev)
    b = maps.shape[0]
    stats = torch.zeros(b + 2 * (max_iter + 1), dtype=torch.int32,
                        device=dev)
    before = cuda_nms.KERNEL.launches
    got = cuda_nms.nms_cuda(maps, d, max_iter, stats=stats)
    assert cuda_nms.KERNEL.launches == before + 1
    want, rounds = fast_nms_rounds(maps, d, max_iter)
    assert got.dtype == maps.dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(stats[:b], rounds)
    if case == "rounds_differ":
        assert len(set(rounds.tolist())) > 1
    if case == "beyond_grid":
        blocks = cuda_nms.nms_grid(d)[0]
        assert b * 16 * 16 > blocks and int(rounds.min()) >= 15
    if max_iter:
        # round 0's mask and round 1's suppression take every tile
        tiles = b * -(-maps.shape[1] // 32) * -(-maps.shape[2] // 32)
        assert stats[b] == tiles and stats[b + max_iter + 2] == tiles


def test_nms_counter_accumulates_under_the_profiler(dev):
    """Under the profiler nms_fixpoint hands kernel A the persistent
    counter: after two calls it holds the sum of two zeroed `stats`
    tensors of the same calls, and the maps equal a call without stats;
    `counters()` zeroes it after the read."""
    from torch.profiler import ProfilerActivity, profile

    from keypoint_bench_tpu_torch.utils import profiling
    maps = [_blurred((3, 100, 130), 2, s).to(dev) for s in (11, 12)]
    name = "kernel_A.stats.B3.iter30"
    profiling.counters()
    want = torch.zeros(3 + 2 * 31, dtype=torch.int32, device=dev)
    with profile(activities=[ProfilerActivity.CPU]):
        got = [cuda_nms.nms_fixpoint(m, 6, 30) for m in maps]
    for m, g in zip(maps, got):
        stats = torch.zeros_like(want)
        assert torch.equal(cuda_nms.nms_cuda(m, 6, 30, stats=stats), g)
        assert torch.equal(cuda_nms.nms_cuda(m, 6, 30), g)
        want += stats
    read = profiling.counters()
    assert torch.equal(read[name], want.cpu())
    assert int(want[:3].sum()) > 0
    assert torch.equal(profiling.counters()[name],
                       torch.zeros_like(want.cpu()))


def _sample_case(dev, b, k, seed,
                 shapes=((160, 224), (80, 112), (20, 28), (5, 7))):
    rng = np.random.default_rng(seed)
    h, w = shapes[0]
    feats = tuple(torch.from_numpy(rng.random((b, 16, hh, ww),
                                              np.float32)).to(dev)
                  for hh, ww in shapes)
    px = torch.from_numpy(rng.uniform(0, w - 1, (b, k)).astype(
        np.float32)).to(dev)
    py = torch.from_numpy(rng.uniform(0, h - 1, (b, k)).astype(
        np.float32)).to(dev)
    edges = torch.tensor([0.0, w - 1.0, w - 1.5], device=dev)[:k]
    px[:, :len(edges)] = edges
    return feats, px, py, h, w


@pytest.mark.parametrize("b,k", [(1, 1), (2, 300), (3, 1000)])
def test_sample_kernel_matches_plain(dev, b, k):
    args = _sample_case(dev, b, k, k)
    got = cuda_sample.sample_cuda(*args)
    want = sample_branches(*args)
    assert got.shape == (b, 64, k)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("lo", [(2, 2), (3, 2), (3, 3)])
def test_sample_kernel_tiny_branches_match_dense_resize(dev, lo):
    """Branches of 2 or 3 rows: the plain twin resizes densely, as the
    reference does; the kernel's composite taps give the same samples."""
    shapes = ((64, 64), (32, 32), (8, 8), lo)
    args = _sample_case(dev, 2, 200, 5, shapes)
    got = cuda_sample.fused_samples_batch(*args)
    want = sample_branches(*args)
    assert float((got - want).abs().max()) <= 1e-5


def _main_path_case(dev, b, k, order, seed):
    """Branches of a 512^2 image (16 channels each) and k points a map,
    in the original or the y-sorted order (the main path's)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = tuple(torch.rand((b, 16, n, n), device=dev, generator=gen)
                  for n in (512, 256, 64, 16))
    px, py = (torch.rand((b, k), device=dev, generator=gen) * 511.0
              for _ in range(2))
    if order == "sorted":
        idx = torch.sort(torch.floor(py), dim=1, stable=True)[1]
        px, py = px.gather(1, idx), py.gather(1, idx)
    return feats, px.contiguous(), py.contiguous(), 512, 512


@pytest.mark.parametrize("order", ["original", "sorted"])
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("k", [1, 127, 129, 1000, 4096])
def test_sample_kernel_at_main_path_shapes(dev, k, b, order):
    args = _main_path_case(dev, b, k, order, k + b)
    before = cuda_sample.KERNEL.launches
    got = cuda_sample.sample_cuda(*args)
    assert cuda_sample.KERNEL.launches == before + 1
    want = sample_branches(*args)
    assert got.shape == (b, 64, k)
    assert float((got - want).abs().max()) <= 1e-5


def test_sample_kernel_launch_args_cached_across_shapes(dev):
    cuda_sample.launch_args.cache_clear()
    one = _sample_case(dev, 2, 300, 1)
    two = _sample_case(dev, 3, 129, 2, ((64, 64), (32, 32), (8, 8), (2, 2)))
    for args in (one, two, one, two):
        got = cuda_sample.sample_cuda(*args)
        assert float((got - sample_branches(*args)).abs().max()) <= 1e-5
    info = cuda_sample.launch_args.cache_info()
    assert (info.currsize, info.hits) == (2, 2)


def test_sample_kernel_skips_zero_weight_taps(dev):
    """Integer points take one tap of branch 0: NaN on every other value
    of that branch must not reach the output."""
    feats, px, py, h, w = _sample_case(dev, 2, 200, 3)
    px = torch.floor(px.clamp(max=w - 2))
    py = torch.floor(py.clamp(max=h - 2))
    f0 = torch.full_like(feats[0], float("nan"))
    bi = torch.arange(2, device=dev)[:, None]
    r, c = py.long(), px.long()
    f0.permute(0, 2, 3, 1)[bi, r, c] = feats[0].permute(0, 2, 3, 1)[bi, r, c]
    got = cuda_sample.sample_cuda((f0,) + feats[1:], px, py, h, w)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[:, :16], feats[0].permute(0, 2, 3, 1)[bi, r, c]
                       .permute(0, 2, 1))


def test_sample_kernel_rejects_bad_input(dev):
    feats, px, py, h, w = _sample_case(dev, 1, 10, 0)
    with pytest.raises(ValueError):
        cuda_sample.sample_cuda(feats, px.double(), py, h, w)
    with pytest.raises(ValueError):
        cuda_sample.sample_cuda(feats, px.cpu(), py, h, w)
    one_row = feats[:3] + (feats[3][:, :, :1].contiguous(),)
    with pytest.raises(ValueError):
        cuda_sample.fused_samples_batch(one_row, px, py, h, w)
    assert cuda_sample.sample_cuda(feats, px[:, :0].contiguous(),
                                   py[:, :0].contiguous(), h, w).numel() == 0


@pytest.mark.parametrize("order", ["original", "sorted"])
@pytest.mark.parametrize("b,k", [(1, 1), (2, 300), (16, 1000)])
def test_sample_kernel_bf16_matches_plain(dev, b, k, order):
    """The bf16 instantiation on bf16 branch maps of a 512^2 image (the
    main path's) and of a 64^2 one (2-row last branch)."""
    for size in (512, 64):
        feats, px, py, h, w = _main_path_case(dev, b, k, order, k + b)
        if size == 64:
            feats = tuple(f[..., :n, :n].contiguous()
                          for f, n in zip(feats, (64, 32, 8, 2)))
            px, py, h, w = px / 8, py / 8, 64, 64
        feats = tuple(f.to(torch.bfloat16) for f in feats)
        before = (cuda_sample.KERNEL.launches,
                  cuda_sample.KERNEL_BF16.launches)
        got = cuda_sample.fused_samples_batch(feats, px, py, h, w)
        assert (cuda_sample.KERNEL.launches,
                cuda_sample.KERNEL_BF16.launches) == (before[0],
                                                      before[1] + 1)
        want = sample_branches(tuple(f.cpu() for f in feats), px.cpu(),
                               py.cpu(), h, w)
        assert got.dtype == torch.float32 and got.shape == (b, 64, k)
        top = max(float(want.abs().max()), 1e-30)
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("b", [1, 16])
def test_sample_kernel_bf16_on_pixel_centred_points(dev, b):
    """Detected keypoints sit at pixel centres, x = (col + 0.5) / W, which
    puts many merged tap weights on bf16 rounding midpoints: one f32 ulp
    in the tap arithmetic (an FMA contraction) then rounds a column
    weight the other way. Every column and row of a 512^2 map."""
    feats, _, _, h, w = _main_path_case(dev, b, 1, "original", b)
    feats = tuple(f.to(torch.bfloat16) for f in feats)
    grid = (torch.arange(512, device=dev, dtype=torch.float32) + 0.5) / 512
    k = 1024
    cols = grid[torch.arange(k, device=dev) % 512]
    rows = grid[(torch.arange(k, device=dev) * 7) % 512]
    px = (cols * (w - 1.0)).expand(b, k).contiguous()
    py = (rows * (h - 1.0)).expand(b, k).contiguous()
    got = cuda_sample.sample_cuda(feats, px, py, h, w)
    want = sample_branches(tuple(f.cpu() for f in feats), px.cpu(),
                           py.cpu(), h, w)
    top = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * top


def test_sample_kernel_bf16_rejects_mixed_dtypes(dev):
    feats, px, py, h, w = _sample_case(dev, 1, 10, 0)
    mixed = (feats[0].to(torch.bfloat16),) + feats[1:]
    with pytest.raises(ValueError, match="one dtype"):
        cuda_sample.sample_cuda(mixed, px, py, h, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_sample.sample_cuda(tuple(f.half() for f in feats), px, py, h,
                                w)


def test_detection_on_card_matches_cpu_and_counts_launches(dev):
    maps = _maps("smooth", (2, 128, 128), 3)
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=300)
    before = cuda_nms.KERNEL.launches
    k, v = detection_batch(maps.to(dev), dp)
    assert cuda_nms.KERNEL.launches == before + 1
    k_cpu, v_cpu = detection_batch(maps, dp)
    assert torch.equal(k.cpu(), k_cpu) and torch.equal(v.cpu(), v_cpu)


def _penalized(b, m, d, seed, integer):
    """[b, m, d+1] descriptors with kernel D's penalty column: integers
    with every row valid (all sums exact in f32), or unit vectors with 15%
    of the rows carrying the sqrt(1e8) penalty."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-3, 4, (b, m, d)).astype(np.float32)
    else:
        x = rng.normal(size=(b, m, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    pen = np.where(rng.random((b, m)) < (0 if integer else 0.15), 1e4, 0.0)
    return np.concatenate([x, pen[..., None]], -1).astype(np.float32)


def _check_nn(got, want, a, b):
    """Equal indices except near ties; distances within 1e-5 of the
    operands' scale |a|^2 + |b|^2 (float64 reference)."""
    a64, b64 = a.double().cpu(), b.double().cpu()
    for side, (x, y) in enumerate(((a64, b64), (b64, a64))):
        nn_g, d_g = got[2 * side].cpu().long(), got[2 * side + 1].cpu()
        nn_w, d_w = want[2 * side].cpu().long(), want[2 * side + 1].cpu()
        xn = (x * x).sum(-1)
        yn = (y * y).sum(-1)

        def dist(nn):
            yy = y.gather(-2, nn[..., None].expand(*nn.shape, y.shape[-1]))
            return ((x - yy) ** 2).sum(-1), xn + yn.gather(-1, nn)

        dg, scale = dist(nn_g)
        dw, _ = dist(nn_w)
        differ = nn_g != nn_w
        assert bool(((dg - dw).abs() <= 1e-5 * scale)[differ].all())
        assert bool(((d_g.double() - d_w.double()).abs()
                     <= 1e-5 * scale).all())


@pytest.mark.parametrize("b,m,n,d", [
    (1, 1, 1, 65), (2, 70, 130, 65), (3, 1000, 1000, 257), (1, 64, 200, 3),
    # M, N off the 128-row tile; D = 1 (one live feature), 300 (a slice
    # tail of 12); 40 pairs of 8 x 8 tiles, beyond one wave of blocks
    (1, 129, 127, 65), (2, 127, 129, 1), (2, 1000, 1, 257), (1, 1, 1000, 65),
    (2, 300, 260, 300), (40, 1000, 1000, 65)])
@pytest.mark.parametrize("integer", [True, False])
def test_match_kernel_matches_plain(dev, b, m, n, d, integer):
    a = torch.from_numpy(_penalized(b, m, d - 1, m, integer)).to(dev)
    bb = torch.from_numpy(_penalized(b, n, d - 1, n + 1, integer)).to(dev)
    if integer and n > 100:
        bb[:, n - 3] = bb[:, 2]          # equal columns in far-apart tiles
    if integer and m > 100:
        a[:, m - 3] = a[:, 2]            # equal rows in far-apart tiles
    got = cuda_match.nn_dists_cuda(a, bb)
    want = nn_dists(a, bb)
    if integer:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    else:
        _check_nn(got, want, a, bb)


def _width_case(b, k, d, seed, exact):
    """[b, k, d] descriptors of the detector family's widths: D = 3 as
    LETNet's / GoodPoint's sigmoid maps (exact: multiples of 1/8, so many
    distances tie exactly), else unit vectors (exact: small integers)."""
    rng = np.random.default_rng(seed)
    if exact:
        x = (rng.integers(0, 9, (b, k, d)) / 8.0 if d == 3
             else rng.integers(-2, 3, (b, k, d)))
    else:
        x = rng.normal(size=(b, k, d))
        x = (1 / (1 + np.exp(-x)) if d == 3
             else x / np.linalg.norm(x, axis=-1, keepdims=True))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("d", [3, 64, 128, 512])
@pytest.mark.parametrize("exact", [True, False])
def test_match_kernel_at_detector_widths(dev, d, exact):
    """Kernel D at the widths this slice's models give it (3: LETNet,
    GoodPoint; 64: EdgePoint; 128: r2d2, DISK, sfd2; 512: D2Net), with
    the penalty column of mutual_nn_fused. Exact sums: indices equal,
    ties to the lowest index, distances equal; float sums: the near-tie
    rule of _check_nn. Then the whole match against the plain one."""
    from keypoint_bench_tpu_torch.ops.matching import penalized
    x0, x1 = (_width_case(4, 1000, d, s, exact) for s in (d, d + 1))
    rng = np.random.default_rng(d)
    v0, v1 = (torch.from_numpy(exact | (rng.random((4, 1000)) > 0.15))
              for _ in range(2))
    a, bb = (penalized(x, v)[0].to(dev) for x, v in ((x0, v0), (x1, v1)))
    got = cuda_match.nn_dists_cuda(a, bb)
    want = nn_dists(a, bb)
    if exact:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # exact ties do occur at D = 3, and the lowest index wins them
        s = nn_dists(a.cpu(), bb.cpu())
        full = ((a.cpu()[..., None, :] - bb.cpu()[:, None]) ** 2).sum(-1) \
            if d == 3 else None
        if full is not None:
            assert int((full == full.min(-1, keepdim=True).values).sum(-1)
                       .gt(1).sum()) > 100
            first = (full == full.min(-1, keepdim=True).values).float()
            assert torch.equal(s[0].long(), first.argmax(-1))
    else:
        _check_nn(got, want, a, bb)
    ok_args = (x0.to(dev), x1.to(dev), v0.to(dev), v1.to(dev), 5.0)
    nn, ok = mutual_nn_match(*ok_args)
    nn_c, ok_c = mutual_nn_fused(*(t.cpu() if torch.is_tensor(t) else t
                                   for t in ok_args))
    if exact:
        assert torch.equal(ok.cpu(), ok_c)
        assert torch.equal(nn.cpu()[ok_c], nn_c[ok_c])
    else:   # near ties may part a few rows
        assert float((ok.cpu() != ok_c).float().mean()) <= 0.005


@pytest.mark.parametrize("integer", [True, False])
def test_match_kernel_pair_with_every_row_penalized(dev, integer):
    """Pair 1's rows all carry the sqrt(1e8) penalty: every distance of
    that pair sits near 1e8, where f32 spacing is 8, so the sums round
    and the rule of near ties applies."""
    a = _penalized(2, 300, 64, 5, integer)
    a[1, :, -1] = 1e4
    a = torch.from_numpy(a).to(dev)
    bb = torch.from_numpy(_penalized(2, 260, 64, 6, integer)).to(dev)
    got = cuda_match.nn_dists_cuda(a, bb)
    _check_nn(got, nn_dists(a, bb), a, bb)
    if integer:                          # no column carries a penalty
        assert bool((got[1][1] >= 1e8 - 1e4).all())


def test_mutual_nn_match_on_card_launches_kernel_d(dev):
    rng = np.random.default_rng(0)
    desc = [torch.from_numpy(rng.integers(-3, 4, (2, 300, 64)).astype(
        np.float32)).to(dev) for _ in range(2)]
    valid = [torch.from_numpy(rng.random((2, 300)) > 0.2).to(dev)
             for _ in range(2)]
    before = cuda_match.KERNEL.launches
    nn, ok = mutual_nn_match(desc[0], desc[1], valid[0], valid[1], 3.0)
    assert cuda_match.KERNEL.launches == before + 2
    nn_c, ok_c = mutual_nn_fused(*(x.cpu() for x in (*desc, *valid)), 3.0)
    # an invalid row's neighbour is rounding noise at the 1e8 penalty
    v0 = valid[0].cpu()
    assert torch.equal(nn.cpu()[v0], nn_c[v0]) and torch.equal(ok.cpu(),
                                                                ok_c)


def test_mutual_nn_match_bf16_on_card_launches_kernel_d(dev):
    rng = np.random.default_rng(1)
    desc = [torch.from_numpy(rng.integers(-3, 4, (2, 300, 64)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for _ in range(2)]
    valid = [torch.from_numpy(rng.random((2, 300)) > 0.2).to(dev)
             for _ in range(2)]
    before = cuda_match.KERNEL.launches
    nn, ok = mutual_nn_match(desc[0], desc[1], valid[0], valid[1], 3.0)
    assert cuda_match.KERNEL.launches == before + 2
    nn_c, ok_c = mutual_nn_fused(*(x.cpu() for x in (*desc, *valid)), 3.0)
    v0 = valid[0].cpu()
    assert torch.equal(nn.cpu()[v0], nn_c[v0]) and torch.equal(ok.cpu(),
                                                                ok_c)


def test_match_kernel_rejects_bad_input(dev):
    a = torch.rand(2, 10, 65, device=dev)
    with pytest.raises(ValueError):
        cuda_match.nn_dists_cuda(a.double(), a.double())
    with pytest.raises(ValueError):
        cuda_match.nn_dists_cuda(a, a[:, :, :64].contiguous())
    with pytest.raises(ValueError):
        cuda_match.nn_dists_cuda(a, a.cpu())


def _qkv(lead, n, m, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((*lead, r, 64), generator=g).to(dev)
            for r in (n, m, m)]


@pytest.mark.parametrize("lead,n,m", [((1,), 1, 1), ((4,), 300, 420),
                                      ((2, 4), 1000, 1000), ((3,), 65, 31)])
@pytest.mark.parametrize("scale", [None, 1.0])
@pytest.mark.parametrize("valid", ["mixed", "none"])
def test_attention_kernel_matches_plain(dev, lead, n, m, scale, valid):
    q, k, v = _qkv(lead, n, m, n + m, dev)
    kv = (torch.rand((*lead, m), device=dev) > 0.3 if valid == "mixed"
          else torch.zeros((*lead, m), dtype=torch.bool, device=dev))
    got = cuda_attention.attention_cuda(q, k, v, kv, scale)
    want = fused_attention(q, k, v, kv, scale)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if valid == "none":
        torch.testing.assert_close(got, v.mean(-2, keepdim=True).expand_as(
            got), atol=1e-5, rtol=1e-5)


def _tile_edges():
    """n, m around kernel E's query and key tiles, and the main path's."""
    bq, bk = cuda_attention.BQ, cuda_attention.BK
    return [(1, bk - 1), (bq - 1, bk), (bq, bk + 1), (bq + 1, 1),
            (bk, bq - 1), (1000, 4096), (4096, 1000)]


@pytest.mark.parametrize("n,m", _tile_edges())
def test_attention_kernel_at_tile_edges(dev, n, m):
    """One row or key short of a tile, a full tile, one over; masks both
    per slice and shared; all keys of one slice invalid."""
    q, k, v = _qkv((3,), n, m, n * 7 + m, dev)
    kv = torch.rand((3, m), device=dev) > 0.2
    kv[1] = False
    got = cuda_attention.attention_cuda(q, k, v, kv)
    want = fused_attention(q, k, v, kv)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], v[1].mean(-2, keepdim=True).expand_as(
        got[1]), atol=1e-5, rtol=1e-5)


def test_attention_kernel_many_slices_and_head_mask(dev):
    """More blocks than the card runs at once (600 slices x 2 query
    tiles), and the mask handed over per head as LightGlue makes it."""
    n = cuda_attention.BQ + 3
    q, k, v = _qkv((150, 4), n, 70, 11, dev)
    kv = torch.rand((150, 70), device=dev) > 0.3
    before = cuda_attention.KERNEL.launches
    got = cuda_attention.masked_attention(q, k, v,
                                          cuda_attention.head_mask(kv, 4))
    assert cuda_attention.KERNEL.launches == before + 1
    torch.testing.assert_close(got, fused_attention(q, k, v, kv[:, None]),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(got, cuda_attention.attention_cuda(q, k, v,
                                                          kv[:, None]))


def test_attention_kernel_broadcasts_mask_and_rejects_bad_input(dev):
    q, k, v = _qkv((2, 4), 50, 70, 0, dev)
    kv = torch.rand((2, 1, 70), device=dev) > 0.5
    torch.testing.assert_close(cuda_attention.attention_cuda(q, k, v, kv),
                               fused_attention(q, k, v, kv),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        cuda_attention.attention_cuda(q[..., :32], k[..., :32],
                                      v[..., :32], kv)
    with pytest.raises(ValueError):
        cuda_attention.attention_cuda(q.double(), k, v, kv)
    with pytest.raises(ValueError):
        cuda_attention.attention_cuda(q, k, v, kv.float())


def test_lightglue_on_card_matches_golden_and_cpu(dev):
    g = np.load(f"{GOLDEN_DIR}/lightglue.npz")
    params = load_golden_params("lightglue")
    args = [torch.from_numpy(x) for x in (
        g["kpts0"][0], np.ones(64, bool), g["desc0"][0], g["kpts1"][0],
        np.ones(80, bool), g["desc1"][0])]
    before = cuda_attention.KERNEL.launches
    m0, ms, _ = tlg.lightglue_forward(
        {k: v.to(dev) for k, v in params.items()}, *(a.to(dev) for a in args))
    # kernel E: one self and one cross launch per layer (K0 != K1 here:
    # two of each)
    assert cuda_attention.KERNEL.launches - before == 9 * 4
    assert (m0.cpu().numpy() == g["matches0"][0]).mean() >= 0.97
    _, ms_cpu, _ = tlg.lightglue_forward(params, *args)
    torch.testing.assert_close(ms.cpu(), ms_cpu, atol=1e-4, rtol=0)


def test_attention_kernel_on_an_emptied_side(dev):
    """Adaptive LightGlue's pruning can leave one side with no valid
    token: its slices attend to all-invalid keys and must be uniform,
    beside a side whose mask is mixed (stacked as the cross block
    stacks both directions, per-head masks)."""
    q, k, v = _qkv((2, 4), 1000, 1000, 5, dev)
    kv = torch.stack([torch.zeros(1000, dtype=torch.bool, device=dev),
                      torch.rand(1000, device=dev) > 0.6])
    mask = cuda_attention.head_mask(kv, 4)
    got = cuda_attention.masked_attention(q, k, v, mask)
    torch.testing.assert_close(got, fused_attention(q, k, v, kv[:, None]),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[0], v[0].mean(-2, keepdim=True).expand_as(
        got[0]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("same", [False, True])
def test_adaptive_lightglue_on_card_matches_dense_form(dev, same):
    """The adaptive forward in its fused form on the card (kernel E on the
    masks of each layer) against its dense form on the CPU and against
    its plain twin on the card: the layers run, every layer's keep counts
    and the matches equal; mscores within the JAX package's 0.08."""
    from keypoint_bench_tpu_torch.models.lightglue_adaptive import \
        lightglue_forward_adaptive
    g = np.load(f"{GOLDEN_DIR}/lightglue_adaptive.npz")
    params = load_golden_params("lightglue")
    n1 = 64 if same else 80
    args = [torch.from_numpy(x) for x in (
        g["kpts0"][0], np.ones(64, bool), g["desc0"][0], g["kpts1"][0][:n1],
        np.ones(n1, bool), g["desc1"][0][:n1])]
    p_dev = {k: v.to(dev) for k, v in params.items()}
    a_dev = [a.to(dev) for a in args]
    runs = []
    for where in ("card", "plain", "cpu"):
        stats = {}
        before = cuda_attention.KERNEL.launches
        if where == "plain":
            with _CHIP_SMOKE["plain_twins"]():
                out = lightglue_forward_adaptive(p_dev, *a_dev, stats=stats)
        elif where == "card":
            out = lightglue_forward_adaptive(p_dev, *a_dev, stats=stats)
        else:
            out = lightglue_forward_adaptive(params, *args, attn="dense",
                                             stats=stats)
        launched = cuda_attention.KERNEL.launches - before
        keep = [(int(a), int(b)) for a, b in stats["keep"]]
        runs.append((out, keep, launched))
    (card, keep, launched), *others = runs
    assert launched == (2 if same else 4) * card[3]
    assert keep[0] < (64, n1)                      # the first layer prunes
    for out, k, n in others:
        assert n == 0 and out[3] == card[3] and k == keep
        assert torch.equal(out[0].cpu(), card[0].cpu())
        torch.testing.assert_close(out[1].cpu(), card[1].cpu(), atol=0.08,
                                   rtol=0)


def _lk_images(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    base = rng.random((b, h // 4, w // 4, c)).astype(np.float32)
    img1 = ndi.gaussian_filter(np.kron(base, np.ones((1, 4, 4, 1),
                                                     np.float32)),
                               (0, 1.0, 1.0, 0))
    return torch.from_numpy(img1), torch.from_numpy(
        np.roll(img1, (1, -2), axis=(1, 2)))


def _lk_points(kind, b, n, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "interior":
        p = rng.uniform(12, min(h, w) - 12, (b, n, 2))
    elif kind == "border":
        # within 3 px of a border or a corner, inside and outside
        p = np.stack([rng.uniform(-3, w + 2, (b, n)),
                      rng.uniform(-3, h + 2, (b, n))], -1)
        side = rng.integers(0, 4, (b, n))
        near = rng.uniform(-3, 3, (b, n))
        p[..., 0] = np.where(side == 0, near, np.where(side == 1,
                                                       w - 1 + near,
                                                       p[..., 0]))
        p[..., 1] = np.where(side == 2, near, np.where(side == 3,
                                                       h - 1 + near,
                                                       p[..., 1]))
    else:   # far off the image: the window-start clamp
        p = np.stack([rng.uniform(-60, w + 60, (b, n)),
                      rng.uniform(-60, h + 60, (b, n))], -1)
    return torch.from_numpy(p.astype(np.float32))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("win", [3, 5, 11, 21])
@pytest.mark.parametrize("kind", ["interior", "border", "off"])
def test_lk_kernel_matches_plain_level(dev, kind, win, c):
    b, n, h, w = 2, 200, 64, 80
    img1, img2 = _lk_images(b, h, w, c, win)
    pts1 = _lk_points(kind, b, n, h, w, 3)
    pts2 = pts1 + torch.from_numpy(np.random.default_rng(4).uniform(
        -2, 2, pts1.shape).astype(np.float32))
    args = [t.to(dev) for t in (img1, img2, pts1, pts2)]
    before = cuda_lk.KERNEL.launches
    got = cuda_lk.lk_level(*args, win, 8)
    assert cuda_lk.KERNEL.launches == before + 1
    want = tlk._lk_level(*args, win, 8)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    if kind == "interior":
        assert float(err.max()) <= 5e-3, float(err.max())
    else:
        # a window that is mostly off the image leaves a near-singular
        # system, where rounding decides the step: hold all but 1%
        assert float((err <= 5e-3).float().mean()) >= 0.99
    # zero iterations give the start back
    assert torch.equal(cuda_lk.lk_level(*args, win, 0), args[3])


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("win", [3, 5, 11, 21])
def test_lk_kernel_start_moves_every_iteration(dev, win, c):
    """A flow of about half a window to catch up with (more loses the
    track, and a lost track is decided by rounding): the window's integer
    start moves again and again, so the cached windows are rebuilt. N = 37
    points a pair (no multiple of anything), two pairs."""
    b, n, h, w = 2, 37, 96, 128
    img1, _ = _lk_images(b, h, w, c, win + c)
    img2 = torch.roll(img1, (0, {3: 2, 5: 3, 11: 6, 21: 12}[win]),
                      dims=(1, 2))
    pts1 = _lk_points("interior", b, n, h, w, 8) + 10
    # the search starts just left of a pixel border and is drawn to +x
    pts2 = pts1.clone()
    pts2[..., 0] = pts2[..., 0].floor() + 0.98
    args = [t.to(dev) for t in (img1, img2, pts1, pts2)]
    moves = torch.zeros(1, dtype=torch.int32, device=dev)
    got = cuda_lk.lk_level_cuda(*args, win, 12, moves=moves)
    want = tlk._lk_level(*args, win, 12)
    assert bool(torch.isfinite(got).all())
    # every point loads once, and most cross the border and load again
    assert int(moves.item()) >= b * n + b * n // 2
    err = (got - want).abs().amax(-1)
    assert float((err <= 5e-3).float().mean()) >= 0.97, float(err.max())
    assert torch.equal(got, cuda_lk.lk_level_cuda(*args, win, 12))


@pytest.mark.parametrize("win", [3, 11, 21])
def test_lk_kernel_on_letnet_descriptor_maps(dev, win):
    """Kernel F at C = 3 on what LETNet's flow source feeds it: the
    sigmoid descriptor maps of two consecutive synthetic-sequence frames,
    on the model's own keypoints; the protocol's pyramid through
    optical_flow_batch_from_angles against the plain levels."""
    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticSequenceDataset
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.weights import load_params
    ds = SyntheticSequenceDataset(3, 256, 0)
    frames = torch.from_numpy(np.stack([ds[i]["image0"] for i in range(3)]))
    model = get_model("LETNet")(load_params("LETNet", device=dev))
    with torch.no_grad():
        score, desc = model(frames.to(dev))
    kpts, _ = detection_batch(score, DetectParams(nms_dist=4, top_k=300))
    assert cuda_lk.smem_bytes(win, 3) <= 48 * 1024
    pts = kpts[:2, :, 0:2]
    angles = torch.rand(pts.shape[:2], generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 6.2832
    lkp = tlk.LKParams(distance=3.0, win_size=win, levels=3, iterations=20)
    before = cuda_lk.KERNEL.launches
    got = tlk.optical_flow_batch_from_angles(desc[:2], desc[1:], pts, pts,
                                             angles, lkp)[0]
    assert cuda_lk.KERNEL.launches == before + 3
    from contextlib import ExitStack
    with ExitStack() as stack:
        stack.callback(setattr, cuda_lk, "lk_level_cuda",
                       cuda_lk.lk_level_cuda)
        cuda_lk.lk_level_cuda = tlk._lk_level
        want = tlk.optical_flow_batch_from_angles(desc[:2], desc[1:], pts,
                                                  pts, angles, lkp)[0]
    assert bool(torch.isfinite(got).all())
    # chip_smoke's protocol rule: 99% of the points within 1e-2 px
    close = (((got - want) * 255).abs() <= 1e-2).all(-1)
    assert float(close.float().mean()) >= 0.99


def test_lk_kernel_takes_windows_above_48_kb(dev):
    """win 31 with 4 channels needs 77 KB of shared memory a block: the
    kernel asks for it."""
    assert cuda_lk.smem_bytes(31, 4) > 48 * 1024
    img1, img2 = _lk_images(1, 96, 96, 4, 2)
    pts1 = _lk_points("interior", 1, 50, 96, 96, 3)
    pts2 = pts1 + 0.7
    args = [t.to(dev) for t in (img1, img2, pts1, pts2)]
    got = cuda_lk.lk_level_cuda(*args, 31, 6)
    want = tlk._lk_level(*args, 31, 6)
    assert float((got - want).abs().max()) <= 5e-3


def test_lk_kernel_shape_rules(dev):
    img = torch.zeros(1, 32, 32, 3, device=dev)
    pts = torch.zeros(1, 4, 2, device=dev)
    for bad in (4, 1):                      # even, below 3
        with pytest.raises(ValueError):
            cuda_lk.lk_level_cuda(img, img, pts, pts, bad, 2)
    with pytest.raises(ValueError):         # shared memory: 31^2 * 16 taps
        cuda_lk.lk_level_cuda(torch.zeros(1, 64, 64, 16, device=dev),
                              torch.zeros(1, 64, 64, 16, device=dev), pts,
                              pts, 31, 2)
    with pytest.raises(ValueError):
        cuda_lk.lk_level_cuda(img, img.double(), pts, pts, 3, 2)
    with pytest.raises(ValueError):         # the counter: one int32
        cuda_lk.lk_level_cuda(img, img, pts, pts, 3, 2,
                              moves=torch.zeros(2, device=dev))
    assert cuda_lk.lk_level_cuda(img, img, pts[:, :0], pts[:, :0], 3,
                                 2).shape == (1, 0, 2)


def test_optical_flow_batch_on_card_matches_plain(dev):
    """Three levels through kernel F against the plain levels, same
    angles: 99% of the points within 1e-2 px."""
    b, n, s = 2, 300, 256
    img1, img2 = _lk_images(b, s, s, 3, 9)
    pts = torch.from_numpy(np.random.default_rng(5).uniform(
        0.05, 0.95, (b, n, 2)).astype(np.float32))
    ang = torch.from_numpy(np.random.default_rng(6).normal(
        0, 6.28, (b, n)).astype(np.float32))
    p = tlk.LKParams(distance=10.0, win_size=21, levels=3, iterations=20)
    args = [t.to(dev) for t in (img1, img2, pts, pts, ang)]
    got, err = tlk.optical_flow_batch_from_angles(*args, p)
    want, _ = tlk.optical_flow_batch_from_angles(
        *[t.cpu() for t in args], p)
    d = (got.cpu() - want).abs().amax(-1) * (s - 1)
    assert float((d <= 1e-2).float().mean()) >= 0.99
    assert float(err.max()) <= 8.0


def _peel_maps(kind, shape, seed):
    if kind == "ties":
        return _maps("ties_bf16", shape, seed).float()
    m = _maps("smooth" if kind != "random" else "random", shape, seed)
    if kind == "sparse":
        return torch.where(m > m.flatten().quantile(0.97), m,
                           torch.zeros_like(m))
    if kind == "nan_signed_zero":
        # sparse maxima on a floor of -0.0 and +0.0 (every third column
        # -0.0), subnormals, and a NaN in a few chunks, two of them in the
        # border
        m = torch.where(m > m.flatten().quantile(0.97), m,
                        torch.zeros_like(m))
        cols = torch.arange(shape[-1])
        m = torch.where((m == 0) & (cols % 3 == 0), -0.0, m)
        m[0, 10, shape[-1] // 2 + 5] = torch.nan
        m[2, 12, 3::17] = 1e-45              # subnormals tie by column
        m[2, 13, 5::19] = -1e-45
        m[1, 20, 1] = torch.nan
        m[2, -1, 0] = torch.nan
    return m


_CHIP_SMOKE = runpy.run_path(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "chip_smoke.py"), run_name="not_main")
# values equal under == (so -0.0 == +0.0), NaN matching NaN; indices equal
_peel_equal = _CHIP_SMOKE["peel_equal"]


# W = 384 at three depths; the widest shapes the rule (W // 128) *
# per_chunk <= 128 allows: 16 chunks of 8, 128 chunks of 1, one of 128
@pytest.mark.parametrize("w,per_chunk", [(384, 1), (384, 8), (384, 32),
                                         (2048, 8), (16384, 1), (128, 128)])
@pytest.mark.parametrize("kind", ["smooth", "random", "ties", "sparse",
                                  "nan_signed_zero"])
def test_peel_kernel_equals_plain(dev, kind, w, per_chunk):
    maps = _peel_maps(kind, (3, 37, w), per_chunk).to(dev)
    before = cuda_nms.PEEL_KERNEL.launches
    v, i = cuda_nms.peel_candidates(maps, 4, per_chunk)
    assert cuda_nms.PEEL_KERNEL.launches == before + 1
    pv, pi = peel_topk(maps, 4, per_chunk)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert _peel_equal(v, i, pv, pi)
    cv, ci = peel_topk(maps.cpu(), 4, per_chunk)
    assert _peel_equal(v.cpu(), i.cpu(), cv, ci)
    if kind == "nan_signed_zero":       # (NaN, W) in every round of it
        blk = (w // 2 + 5) // 128
        nan_v = v[0, 10, blk * per_chunk:(blk + 1) * per_chunk]
        nan_i = i[0, 10, blk * per_chunk:(blk + 1) * per_chunk]
        assert bool(torch.isnan(nan_v).all()) and bool((nan_i == w).all())
        assert not bool(torch.isnan(v[1:]).any())     # border NaNs read 0


def test_peel_kernel_minus_inf_and_rules(dev):
    m = torch.full((1, 8, 128), -torch.inf, device=dev)
    m[0, :, 40] = 0.25
    m[0, 3, 7] = 0.5
    v, i = cuda_nms.peel_cuda(m, 0, 4)
    pv, pi = peel_topk(m, 0, 4)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert i[0, 3].tolist() == [7, 40, 0, 0]      # -inf stays the lowest
    # a NaN chunk gives (NaN, W) in every round; -0.0 ties with +0.0 by
    # column; -inf repeats at the widest shapes too; a map that is not
    # 16-byte aligned is copied first
    for w, pc in ((256, 4), (2048, 8), (16384, 1), (128, 128)):
        buf = torch.full((1 + 8 * w,), -torch.inf, device=dev)
        m = buf[1:].view(1, 8, w)
        m[0, 0, w - 100] = torch.nan
        m[0, 1] = 0.0
        m[0, 1, ::2] = -0.0
        m[0, 2, 9] = 0.5
        m[0, 3, -1] = -0.0
        v, i = cuda_nms.peel_cuda(m, 0, pc)
        pv, pi = peel_topk(m, 0, pc)
        assert _peel_equal(v, i, pv, pi)
        last = slice((w // 128 - 1) * pc, (w // 128) * pc)
        assert bool(torch.isnan(v[0, 0, last]).all())
        assert i[0, 0, last].tolist() == [w] * pc
        assert i[0, 1, :pc].tolist() == list(range(pc))
        assert bool((v[0, 1, :pc] == 0).all())
        assert i[0, 2, :pc].tolist() == ([9] + [0] * (pc - 1))
        assert i[0, 3, last].tolist() == [w - 1] + [w - 128] * (pc - 1)
    for shape, pc in (((1, 8, 100), 8), ((1, 8, 2176), 8), ((1, 8, 128), 0)):
        with pytest.raises(ValueError):
            cuda_nms.peel_cuda(torch.zeros(shape, device=dev), 2, pc)
    with pytest.raises(ValueError):
        cuda_nms.peel_cuda(torch.zeros(1, 8, 128, device=dev).double(), 2, 8)


@pytest.mark.parametrize("kind,unsafe", [("smooth", False), ("ties", True)])
def test_fused_detection_on_card_equals_unfused(dev, kind, unsafe):
    maps = _peel_maps(kind, (4, 128, 256), 21).to(dev)
    dp = DetectParams(nms_dist=2 if unsafe else 4, border_dist=8, top_k=300)
    fk, fv = detection_batch_fused(maps, dp)
    pk, pv = detection_batch(maps, dp)
    assert torch.equal(fk, pk) and torch.equal(fv, pv)
    assert fused_topk(maps, dp, 300)[2] == unsafe


def test_vo_step_on_card_matches_plain(dev):
    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticSplatSequenceDataset
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.pipeline import vo_step
    from keypoint_bench_tpu_torch.weights import load_params
    ds = SyntheticSplatSequenceDataset(4, 256, 0)
    items = [ds[i] for i in range(4)]
    frames = np.stack([it["image0"] for it in items])
    scales = [float(np.linalg.norm(it["ground_truth"][:3, 3]
                                   - it["last_ground_truth"][:3, 3]))
              for it in items]
    model = get_model("Alike_s2d")(load_params("Alike_s2d", device=dev))
    dp = DetectParams(nms_dist=4, border_dist=8, top_k=300)

    def run():
        return vo_step(model, frames, ds.base.K, scales, dp,
                       torch.Generator(device=dev).manual_seed(0),
                       n_hyp=256, ba_refine=True, device=dev)

    kernels = (cuda_nms.KERNEL, cuda_sample.KERNEL, cuda_match.KERNEL)
    before = [k.launches for k in kernels]
    got = run()
    assert all(k.launches > b for k, b in zip(kernels, before))
    with _CHIP_SMOKE["plain_twins"]():
        want = run()
    assert torch.equal(got["kpts"], want["kpts"])
    assert torch.equal(got["valid"], want["valid"])
    differ = int((got["match_mask"] != want["match_mask"]).sum()
                 + ((got["nn01"] != want["nn01"]) & got["match_mask"]).sum())
    assert differ <= 0.005 * int(got["valid"].sum())
    assert np.isfinite(got["t_est"]).all() and got["ba_tracks"] > 100
    if differ == 0:
        length = np.linalg.norm(np.diff(want["t_est"][:, :, 0], axis=0),
                                axis=1).sum()
        assert np.abs(got["t_est"] - want["t_est"]).max() <= 1e-3 * length
        assert got["ba_tracks"] == want["ba_tracks"]
        assert abs(got["ba_reproj_after"] - want["ba_reproj_after"]) <= 1e-3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-6)])
def test_ba_solve_on_card_matches_cpu(dev, dtype, tol):
    from keypoint_bench_tpu_torch.ba import BAProblem, ba_solve
    from keypoint_bench_tpu_torch.datasets.synthetic import rodrigues
    rng = np.random.default_rng(1)
    C, P = 6, 80
    pts = np.c_[rng.uniform(-2, 2, (P, 2)), rng.uniform(6, 12, P)]
    Rs = np.stack([rodrigues(rng.normal(0, 0.05, 3)) for _ in range(C)])
    ts = np.array([[0.3 * c, 0.05 * c, 0.0] for c in range(C)])
    Kc = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    ci, pi = np.meshgrid(np.arange(C), np.arange(P), indexing="ij")
    ci, pi = ci.ravel(), pi.ravel()
    Xc = np.einsum("nij,nj->ni", Rs[ci], pts[pi]) + ts[ci]
    uv = Xc[:, :2] / Xc[:, 2:] * 400.0 + [320, 240] + rng.normal(
        0, 0.5, (len(ci), 2))
    R0 = np.stack([Rs[0]] + [rodrigues(rng.normal(0, 0.01, 3)) @ R
                             for R in Rs[1:]])
    t0 = np.concatenate([ts[:1], ts[1:] + rng.normal(0, 0.05, (C - 1, 3))])
    p0 = pts + rng.normal(0, 0.02, pts.shape)
    sols = []
    for d in (dev, torch.device("cpu")):
        def f(x):
            return torch.as_tensor(x, dtype=dtype, device=d)
        prob = BAProblem(f(R0), f(t0), f(p0), torch.as_tensor(ci, device=d),
                         torch.as_tensor(pi, device=d), f(uv),
                         torch.ones(len(ci), dtype=torch.bool, device=d),
                         f(Kc))
        R, t, p, e = ba_solve(prob, iters=8, damping=1e-2, huber_delta=2.0)
        sols.append(([x.cpu().numpy() for x in (R, t, p)], float(e)))
    (card, e_card), (cpu, e_cpu) = sols
    assert abs(e_card - e_cpu) <= tol and e_card < 1.0
    s, gap_r, gap_c, gap_p = _CHIP_SMOKE["gauge_gap"](card, cpu)
    assert abs(s - 1.0) <= 0.05 and max(gap_r, gap_c, gap_p) <= tol


# The eval BatchNorm epilogue (csrc/bn_epilogue.cu). The shapes are the
# cells' ([32,8,512,512] ALIKE-t block1, [32,16,256,256] block2,
# [32,64,16,16] block4, [4,128,512,512] R2D2) and odd ones: B = 1, C = 1,
# H*W not a multiple of 8 (so planes start off the vector width), H*W 1.
_BN_SHAPES = [(32, 8, 512, 512), (32, 16, 256, 256), (32, 64, 16, 16),
              (4, 128, 512, 512), (1, 3, 5, 7), (2, 1, 9, 13), (3, 5, 1, 1),
              (1, 1, 1, 3)]


def _bn_case(dev, shape, dtype, affine, res_dtype, seed=0, offset=0,
             with_bias=False):
    """x of `dtype` with NaN, +-inf and -0.0 at the first and last
    elements and at random ones; f32 statistics (channel 0: mean 0, beta
    -0.0, so -0.0 reaches the ReLU); a residual of `res_dtype` or None; an
    f32 conv bias (channel 0: -0.0) or None. `offset` > 0 places x and the
    residual that many elements into their buffers (contiguous, off
    16-byte alignment)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, c, h, w = shape
    numel = n * c * h * w

    def field(scale, dt):
        buf = torch.empty(numel + offset, dtype=dt, device=dev)
        t = buf[offset:].view(shape)
        t.copy_(torch.randn(shape, generator=g, device=dev) * scale)
        return t
    xf = torch.randn(shape, generator=g, device=dev) * 3
    at = torch.cat([torch.tensor([0, numel - 1], device=dev),
                    torch.randint(0, numel, (40,), generator=g, device=dev)])
    specials = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0,
                             0.0], device=dev)
    xf.view(-1)[at] = specials.repeat(9)[:at.numel()]
    x = field(0, dtype)
    x.copy_(xf)
    mean = torch.randn(c, generator=g, device=dev)
    mean[0] = 0.0
    var = torch.rand(c, generator=g, device=dev) * 2
    gamma = beta = None
    if affine:
        gamma = torch.randn(c, generator=g, device=dev)
        beta = torch.randn(c, generator=g, device=dev)
        beta[0] = -0.0
    res = None
    if res_dtype is not None:
        res = field(2, res_dtype)
        res.view(-1)[torch.randint(0, numel, (8,), generator=g,
                                   device=dev)] = -0.0
    bias = None
    if with_bias:
        bias = torch.randn(c, generator=g, device=dev)
        bias[0] = -0.0
    return x, gamma, beta, mean, var, res, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("res_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BN_SHAPES, ids=str)
def test_bn_epilogue_kernel_equals_chain(dev, shape, dtype, res_dtype,
                                         affine, relu, with_bias):
    x, gamma, beta, mean, var, res, bias = _bn_case(
        dev, shape, dtype, affine, res_dtype, with_bias=with_bias)
    want = tcommon.bn_chain(x, gamma, beta, mean, var, 1e-5, relu, res, bias)
    before = cuda_bn.KERNEL.launches
    got = tcommon.bn_eval(x, gamma, beta, mean, var, relu=relu, residual=res,
                          bias=bias)
    torch.cuda.synchronize()
    assert cuda_bn.KERNEL.launches == before + 1
    same_bits(got, want)


@pytest.mark.parametrize("res_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_epilogue_kernel_off_16_byte_alignment(dev, dtype, res_dtype):
    """Pointers off 16-byte alignment take the scalar path, with the same
    bits."""
    x, gamma, beta, mean, var, res, bias = _bn_case(
        dev, (2, 3, 40, 24), dtype, True, res_dtype, seed=3, offset=1,
        with_bias=True)
    assert x.data_ptr() % 16 != 0
    got = cuda_bn.bn_epilogue(x, gamma, beta, mean, var, 1e-5, True, res,
                              bias)
    same_bits(got, tcommon.bn_chain(x, gamma, beta, mean, var, 1e-5, True,
                                    res, bias))


def test_bn_epilogue_kernel_rejects_bad_input(dev):
    x, gamma, beta, mean, var, res, bias = _bn_case(
        dev, (2, 4, 8, 8), torch.float32, True, torch.float32,
        with_bias=True)
    before = cuda_bn.KERNEL.launches
    bad = [
        (x.to(memory_format=torch.channels_last), gamma, beta, mean, var,
         None, None),                                    # not NCHW
        (x.half(), gamma, beta, mean, var, None, None),  # dtype
        (x.cpu(), gamma, beta, mean, var, None, None),   # not on the card
        (x[0], gamma, beta, mean, var, None, None),      # not 4-d
        (x, gamma, None, mean, var, None, None),      # gamma without beta
        (x, gamma, beta, mean.double(), var, None, None),
        (x, gamma, beta, mean[:3], var, None, None),
        (x, gamma, beta, mean, var, None, bias[:3]),     # bias's shape
        (x, gamma, beta, mean, var, None, bias.cpu()),
        (x, gamma, beta, mean, var, res[:, :3], None),   # residual's shape
        (x, gamma, beta, mean, var, res.transpose(2, 3), None)]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_bn.bn_epilogue(*args[:5], 1e-5, True, *args[5:])
    assert cuda_bn.KERNEL.launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_bn.bn_epilogue(x.clone().requires_grad_(), gamma, beta, mean,
                            var)


# (model, weights, input size, forward or feats, kernel launches a forward)
_BN_MODELS = [("Alike", "npz", 512, "feats", 8), ("r2d2", "npz", 512,
                                                   "forward", 8),
              ("EdgePoint", "npz", 128, "forward", 8),
              ("GoodPoint", "npz", 128, "forward", 2),
              ("LETNet", "npz", 128, "forward", 2),
              ("KeyNet", "npz", 128, "forward", 9),
              ("sfd2", "golden", 128, "forward", 17)]


def _bn_model(name, weights, dev, precision):
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.weights import load_params
    params = (load_params(name, device=dev, precision=precision)
              if weights == "npz" else load_golden_params(name, dev))
    if weights != "npz" and precision == "bfloat16":
        params = tcommon.cast_params_bf16(params)
    return get_model(name)(params).eval()


def _parent_conv_bn(x, w, b, bn, stride=1, padding=0, dilation=1,
                    groups=1, relu=False, residual=None):
    """`conv_bn` as the models ran it before the epilogue kernel: the conv
    with its bias (cuDNN, then torch's bias pass), then the chain."""
    return tcommon.bn_chain(tcommon.conv2d(x, w, b, stride, padding,
                                           dilation, groups), *bn, relu=relu,
                            residual=residual)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,weights,size,call,launches", _BN_MODELS,
                         ids=[m[0] for m in _BN_MODELS])
def test_bn_models_on_card_equal_the_plain_chain(dev, monkeypatch, name,
                                                 weights, size, call,
                                                 launches, precision):
    """Whole forwards of every model built on the epilogue: the kernel's
    path (R2D2's and KeyNet's conv biases added by the kernel) and the
    plain chain's as the models ran it before (the conv with its bias; on
    the card, the same convolutions, cuDNN deterministic) give the same
    bits, and the kernel runs once a BatchNorm."""
    from torch.utils._pytree import tree_leaves
    model = _bn_model(name, weights, dev, precision)
    g = torch.Generator(device=dev).manual_seed(7)
    img = torch.rand((2, size, size, 3), generator=g, device=dev)
    outs = []
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        before = cuda_bn.KERNEL.launches
        outs.append(getattr(model, call)(img))
        assert cuda_bn.KERNEL.launches == before + launches
        with monkeypatch.context() as m:
            m.setattr(cuda_bn, "bn_epilogue", tcommon.bn_chain)
            m.setattr(tcommon, "conv_bn", _parent_conv_bn)
            outs.append(getattr(model, call)(img))
        assert cuda_bn.KERNEL.launches == before + launches
    got, want = (tree_leaves(o) for o in outs)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        same_bits(a, b)


@pytest.mark.parametrize("name,call", [("Alike", "feats"),
                                       ("r2d2", "forward")])
def test_bn_epilogue_counter_reads_8_a_forward(dev, name, call):
    """Under a profiler every BatchNorm of the forward adds 1 to the
    counter `models.bn_epilogue`: 8 for ALIKE-t's `feats` and for R2D2."""
    from torch.profiler import ProfilerActivity, profile

    from keypoint_bench_tpu_torch.utils import profiling
    model = _bn_model(name, "npz", dev, "float32")
    img = torch.rand((2, 256, 256, 3), device=dev)
    profiling.counters()
    with torch.inference_mode():
        getattr(model, call)(img)      # no profiler: no counter
        with profile(activities=[ProfilerActivity.CPU]):
            getattr(model, call)(img)
            getattr(model, call)(img)
    assert int(profiling.counters()["models.bn_epilogue"]) == 16


def test_exported_alike_on_card_launches_the_kernel(dev, tmp_path):
    """torch.export records each epilogue as the operator
    `kbt::bn_epilogue` (8 in ALIKE-t's forward); the loaded program
    launches the kernel 8 times and gives the eager forward's bits."""
    from torch.utils._pytree import tree_leaves

    from keypoint_bench_tpu_torch.utils.export import (export_model,
                                                       load_exported)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        path = export_model("Alike", str(tmp_path / "alike.pt2"),
                            (1, 64, 64, 3), device=dev)
        nodes = [n for n in torch.export.load(path).graph.nodes
                 if n.op == "call_function"
                 and "kbt.bn_epilogue" in str(n.target)]
        assert len(nodes) == 8
        img = torch.rand((1, 64, 64, 3), device=dev)
        before = cuda_bn.KERNEL.launches
        got = load_exported(path)(img)
        assert cuda_bn.KERNEL.launches == before + 8
        with torch.inference_mode():
            model = _bn_model("Alike", "npz", dev, "float32")
            want = model(img)
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        same_bits(a, b)
