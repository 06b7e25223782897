"""Kernel B's collapsed tap windows (csrc/sample.cu) mirrored on the CPU.

Along an axis, the composite taps of sampling an align-corners upsample
read rows la, la+1, lb, lb+1 with lb == la or la + 1, so the kernel
merges them onto at most three rows la..la+2 (`taps_up`), skips every tap
whose merged weight is 0 (neither loaded nor summed) and sums per row
t = ((wc0 v0) + wc1 v1) + wc2 v2, then ((wr0 t0) + wr1 t1) + wr2 t2.
`_mirror_sample` below does the same in torch. It is held against the
plain `_axis_taps_up` contraction (`sample_branches`) within 1e-6 (f32,
another order of the same products) and against the JAX package's
samplers and its Pallas `_kernel` in interpret mode within 1e-5, as
tests/test_torch_sparse_desc.py holds the plain version. Cases: the
branch ratios of a 512^2 and a 96^2 image, branches of 2 and 3 rows, and
points at 0, n-1, n-1.5 and just under integers.

The wrapper's per-shape launch arguments (`cuda_sample.launch_args`) are
plain Python and are checked here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ops import pallas_sample
from keypoint_bench_tpu.ops import sparse_desc as jsd
from keypoint_bench_tpu_torch.ops import cuda_sample
from keypoint_bench_tpu_torch.ops import sparse_desc as tsd

# (full resolution, branch sizes) of ALIKE at a 512^2, a 96^2 (last branch
# 3 x 3) and a 64^2 (last branch 2 x 2) image
IMAGES = {512: (512, 256, 64, 16), 96: (96, 48, 12, 3), 64: (64, 32, 8, 2)}
AXES = [(sizes[0], n_lo) for sizes in IMAGES.values() for n_lo in sizes[1:]]


def _merged_taps_direct(p, n):
    """Branch 0 (`taps_direct`): base clip(floor(p), 0, n-2), weights
    (1-dy, dy, 0)."""
    f = torch.floor(p)
    dy = p - f
    base = torch.clamp(f.long(), 0, n - 2)
    return base, torch.stack([1.0 - dy, dy, torch.zeros_like(dy)], -1)


def _merged_taps_up(p, n_hi, n_lo):
    """Branches i >= 1 (`taps_up`): rows la..la+2 and merged weights."""
    f = torch.floor(p)
    dy = p - f
    y0 = f.long()
    s = torch.tensor(float(cuda_sample.upsample_ratio(n_lo, n_hi)))

    def lo_frac(y):
        src = y.float() * s
        lo = torch.clamp(torch.floor(src).long(), 0, n_lo - 2)
        return lo, src - lo.float()

    la, fa = lo_frac(y0)
    lb, fb = lo_frac(torch.clamp_max(y0, n_hi - 2) + 1)
    a0, a1 = (1.0 - dy) * (1.0 - fa), (1.0 - dy) * fa
    b0, b1 = dy * (1.0 - fb), dy * fb
    three = lb == la + 1
    return la, torch.stack([torch.where(three, a0, a0 + b0),
                            torch.where(three, a1 + b0, a1 + b1),
                            torch.where(three, b1, torch.zeros_like(b1))],
                           -1), lb - la


def _mirror_sample(feats_b, px, py, h, w):
    """Kernel B's sums on the CPU: [B, sum C_i, K] f32."""
    outs = []
    ar = torch.arange(3)
    for i, f in enumerate(feats_b):
        b, c, hi, wi = f.shape
        k = px.shape[1]
        if i == 0:
            rb, wr = _merged_taps_direct(py, hi)
            cb, wc = _merged_taps_direct(px, wi)
        else:
            rb, wr, _ = _merged_taps_up(py, h, hi)
            cb, wc, _ = _merged_taps_up(px, w, wi)
        live = (wr[..., :, None] != 0) & (wc[..., None, :] != 0)
        idx = ((rb[..., None] + ar)[..., :, None] * wi
               + (cb[..., None] + ar)[..., None, :])
        idx = torch.where(live, idx, 0)                 # nothing is read
        v = f.reshape(b, c, hi * wi).gather(
            2, idx.reshape(b, 1, k * 9).expand(b, c, k * 9))
        v = torch.where(live[:, None], v.reshape(b, c, k, 3, 3), 0.0)
        acc = torch.zeros((b, c, k))
        for r in range(3):
            t = torch.zeros((b, c, k))
            for q in range(3):
                t = t + wc[:, None, :, q] * v[..., r, q]
            acc = acc + wr[:, None, :, r] * t
        outs.append(acc)
    return torch.cat(outs, 1)


def _points(rng, n, k, outside=True):
    """k coordinates along an axis of n rows: the clip edges, values just
    under integers, two outside the map (if `outside`), the rest uniform.
    Keypoints lie inside the map; outside it the plain version's dense
    resize of 2- and 3-row branches is not the composite taps' sample."""
    p = rng.uniform(0.0, n - 1.0, k).astype(np.float32)
    ints = np.round(np.linspace(1, n - 1, 8)).astype(np.float32)
    edges = np.concatenate([
        np.array([0.0, n - 1.0, n - 1.5], np.float32),
        np.array([-0.25, n - 0.75] if outside else [], np.float32),
        np.nextafter(ints, np.float32(-np.inf))])
    p[:len(edges)] = edges
    return p


def _dense(base, wt, n):
    """Axis taps (base [K], weights [K, T]) as a dense [K, n] matrix; taps
    outside 0..n-1 must carry weight 0."""
    rows = base[:, None] + torch.arange(wt.shape[1])
    inside = (rows >= 0) & (rows < n)
    assert bool((wt[~inside] == 0).all())
    out = torch.zeros((base.shape[0], n))
    out.scatter_add_(1, torch.where(inside, rows, 0),
                     torch.where(inside, wt, 0.0))
    return out


@pytest.mark.parametrize("n_hi,n_lo", AXES,
                         ids=[f"{a}to{b}" for a, b in AXES])
def test_merged_window_equals_composite_taps(n_hi, n_lo):
    p = torch.from_numpy(_points(np.random.default_rng(n_lo), n_hi, 400))
    base, wt, span = _merged_taps_up(p, n_hi, n_lo)
    assert bool(((span == 0) | (span == 1)).all())
    assert cuda_sample.window_fits(n_hi, n_lo)
    assert bool((base >= 0).all() and (base <= n_lo - 2).all())
    pb, pw = tsd._axis_taps_up(p, n_hi, n_lo)
    np.testing.assert_allclose(_dense(base, wt, n_lo).numpy(),
                               _dense(pb, pw, n_lo).numpy(), atol=1e-6)
    jb, jw = jsd._axis_taps_up(jnp.asarray(p.numpy()), n_hi, n_lo)
    np.testing.assert_allclose(
        _dense(base, wt, n_lo).numpy(),
        _dense(torch.from_numpy(np.array(jb)).long(),
               torch.from_numpy(np.array(jw)), n_lo).numpy(), atol=1e-6)
    # the 2-row window of lb == la is the usual case off branch 1
    if n_lo <= n_hi // 8:
        assert float((span == 0).float().mean()) > 0.5


@pytest.mark.parametrize("n", [512, 96, 64])
def test_merged_direct_taps_equal_plain(n):
    p = torch.from_numpy(_points(np.random.default_rng(n), n, 300))
    base, wt = _merged_taps_direct(p, n)
    pb, pw = tsd._axis_taps_direct(p, n)
    assert torch.equal(base, pb) and torch.equal(wt[:, :2], pw)


def _case(size, b=1, c=4, k=300, seed=0):
    rng = np.random.default_rng(seed)
    feats = tuple(torch.from_numpy(rng.random((b, c, n, n), np.float32))
                  for n in IMAGES[size])
    px = np.stack([_points(rng, size, k, False) for _ in range(b)])
    py = np.stack([rng.permutation(_points(rng, size, k, False))
                   for _ in range(b)])
    return feats, torch.from_numpy(px), torch.from_numpy(py)


@pytest.mark.parametrize("size", sorted(IMAGES))
def test_mirror_matches_plain_sampler(size):
    feats, px, py = _case(size, b=2, seed=size)
    got = _mirror_sample(feats, px, py, size, size)
    want = tsd.sample_branches(feats, px, py, size, size)
    assert got.shape == want.shape == (2, 16, px.shape[1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("size", [512, 96])
def test_mirror_matches_pallas_kernel(size):
    """The Pallas `_kernel` in interpret mode (features padded as its
    dispatch pads them, K padded to its 128-lane tile): within 1e-5."""
    k, kp = 200, 256
    feats, px, py = _case(size, b=1, k=k, seed=size + 1)
    pad = ((0, 0), (0, kp - k))
    ref = pallas_sample.fused_samples_batch(
        tuple(jsd._pad_feat_cm(jnp.asarray(f.numpy())) for f in feats),
        jnp.asarray(np.pad(px.numpy(), pad)),
        jnp.asarray(np.pad(py.numpy(), pad)), size, size,
        tuple((n, n) for n in IMAGES[size][1:]), interpret=True)
    np.testing.assert_allclose(
        _mirror_sample(feats, px, py, size, size).numpy(),
        np.asarray(ref)[:, :, :k], atol=1e-5)


@pytest.mark.parametrize("size", sorted(IMAGES))
def test_mirror_matches_jax_per_map_samplers(size):
    """JAX `sample_direct` / `sample_upsampled` per map (dense resize for
    the 2- and 3-row branches): within 1e-5."""
    feats, px, py = _case(size, b=1, k=200, seed=size + 2)
    got = _mirror_sample(feats, px, py, size, size)[0]
    jx, jy = jnp.asarray(px[0].numpy()), jnp.asarray(py[0].numpy())
    for i, f in enumerate(feats):
        fm = jnp.asarray(f[0].permute(1, 2, 0).numpy())
        want = (jsd.sample_direct(fm, jx, jy) if i == 0 else
                jsd.sample_upsampled(fm, jx, jy, size, size))
        np.testing.assert_allclose(got[4 * i:4 * i + 4].T.numpy(),
                                   np.asarray(want), atol=1e-5,
                                   err_msg=f"branch {i}")


def test_zero_weight_taps_are_neither_read_nor_summed():
    """NaN wherever only zero-weight taps reach: integer points take one
    tap of branch 0, and a 2-row window (lb == la) leaves row la+2 out."""
    size = 64
    feats, px, py = _case(size, b=1, k=50, seed=7)
    px = torch.floor(px.clamp(0, size - 2))
    py = torch.floor(py.clamp(0, size - 2))
    f0 = torch.full_like(feats[0], float("nan"))
    r, c = py[0].long(), px[0].long()
    f0[0, :, r, c] = feats[0][0, :, r, c]
    got = _mirror_sample((f0,) + feats[1:], px, py, size, size)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[0, :4].numpy(),
                               feats[0][0, :, r, c].numpy(), atol=0)


def _shapes(b=2, c=16, sizes=(64, 32, 8, 2), k=100):
    return (tuple(torch.Size((b, c, n, n)) for n in sizes),
            torch.Size((b, k)), torch.Size((b, k)))


def test_launch_args_cached_per_shape():
    cuda_sample.launch_args.cache_clear()
    one = cuda_sample.launch_args(*_shapes(), 64, 64)
    assert cuda_sample.launch_args(*_shapes(), 64, 64) is one
    two = cuda_sample.launch_args(*_shapes(sizes=(96, 48, 12, 3), k=7), 96,
                                  96)
    assert cuda_sample.launch_args.cache_info().currsize == 2
    assert two is not one
    b, k, c, hs, ws, sy, sx = two
    assert (b, k, c, list(hs), list(ws)) == (2, 7, 16, [96, 48, 12, 3],
                                             [96, 48, 12, 3])
    assert list(sy) == [float(cuda_sample.upsample_ratio(n, 96))
                        for n in (96, 48, 12, 3)] == list(sx)


@pytest.mark.parametrize("bad", ["px_rank", "py_shape", "batch", "channels",
                                 "branch0", "one_row", "finer"])
def test_launch_args_reject_what_the_kernel_does_not_take(bad):
    feats, ps, qs = _shapes()
    h = w = 64
    if bad == "px_rank":
        ps = qs = torch.Size((200,))
    elif bad == "py_shape":
        qs = torch.Size((2, 99))
    elif bad == "batch":
        feats = feats[:1] + (torch.Size((3, 16, 32, 32)),) + feats[2:]
    elif bad == "channels":
        feats = feats[:1] + (torch.Size((2, 8, 32, 32)),) + feats[2:]
    elif bad == "branch0":
        h = 80
    elif bad == "one_row":
        feats = feats[:3] + (torch.Size((2, 16, 1, 2)),)
    else:                       # 96 rows on a 64-row image: lb - la == 2
        feats = feats[:1] + (torch.Size((2, 16, 96, 96)),) + feats[2:]
    with pytest.raises(ValueError):
        cuda_sample.launch_args(feats, ps, qs, h, w)


def test_window_fits_every_alike_image_size():
    """ALIKE's branches (1/2, 1/8, 1/32 of the image) fit the 3-row window
    at every image size from 64 to 2048 in steps of 32."""
    for n in range(64, 2049, 32):
        assert all(cuda_sample.window_fits(n, n // r) for r in (2, 8, 32))
