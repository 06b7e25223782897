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
`_lk_level`). Kernel C (the peel) only compares and selects: bit-equal
values, equal indices.
"""
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from keypoint_bench_tpu_torch.models import lightglue as tlg
from keypoint_bench_tpu_torch.ops import (cuda_attention, cuda_lk,
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
        "ties_bf16": (ties, 2, 30)}


@pytest.mark.parametrize("case", sorted(_nms_cases()))
def test_nms_kernel_bit_equal_per_map_rounds(dev, case):
    """Bit equality with fast_nms, one launch, and the rounds the kernel
    ran for each map equal to fast_nms_rounds': maps off the 32-pixel
    tiles, d = 1 and 16, max_iter cutting maps that still change, maps
    stopping in different rounds, more tiles (24 x 256) than the resident
    grid holds blocks, on maps that need 20-30 rounds (values other blocks
    wrote before a grid barrier must be read fresh), a constant map and a
    tie-heavy bf16 map."""
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
    return m


@pytest.mark.parametrize("per_chunk", [1, 8, 32])
@pytest.mark.parametrize("kind", ["smooth", "random", "ties", "sparse"])
def test_peel_kernel_equals_plain(dev, kind, per_chunk):
    maps = _peel_maps(kind, (3, 37, 384), per_chunk).to(dev)
    before = cuda_nms.PEEL_KERNEL.launches
    v, i = cuda_nms.peel_candidates(maps, 4, per_chunk)
    assert cuda_nms.PEEL_KERNEL.launches == before + 1
    pv, pi = peel_topk(maps, 4, per_chunk)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert torch.equal(v, pv) and torch.equal(i, pi)
    cv, ci = peel_topk(maps.cpu(), 4, per_chunk)
    assert torch.equal(v.cpu(), cv) and torch.equal(i.cpu(), ci)


def test_peel_kernel_minus_inf_and_rules(dev):
    m = torch.full((1, 8, 128), -torch.inf, device=dev)
    m[0, :, 40] = 0.25
    m[0, 3, 7] = 0.5
    v, i = cuda_nms.peel_cuda(m, 0, 4)
    pv, pi = peel_topk(m, 0, 4)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert i[0, 3].tolist() == [7, 40, 0, 0]      # -inf stays the lowest
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
