"""Sparse descriptors in the PyTorch port vs the JAX reference (CPU).

The port's plain sampler (the twin of CUDA kernel B) is held against the
Pallas sampler kernels in interpret mode, `fused_samples_batch` and
`fused_samples_sorted_batch`, at rtol 1e-5 (atol 1e-6): both are exact f32
sums of the same <= 16 products per channel, in different orders. The
y-ordered API must give the reference's order, keypoints and masks
exactly, and its descriptors within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models.alike_s2d import (alike_s2d_feats_cm,
                                                 transform_params_s2d)
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu.ops import pallas_sample
from keypoint_bench_tpu.ops import sparse_desc as jsd
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.ops import sparse_desc as tsd
from keypoint_bench_tpu_torch.weights import load_npz, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 128, 160
SHAPES = [(128, 160), (64, 80), (16, 20), (4, 5)]


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


def _branches(rng, b=2, c=16):
    return [rng.random((b, c, h, w), np.float32) for h, w in SHAPES]


def _coords(rng, b, k):
    px = rng.uniform(0, W - 1.001, (b, k)).astype(np.float32)
    py = rng.uniform(0, H - 1.001, (b, k)).astype(np.float32)
    return px, py


def _plain(feats, px, py):
    return tsd.sample_branches(tuple(torch.from_numpy(f) for f in feats),
                               torch.from_numpy(px), torch.from_numpy(py),
                               H, W).numpy()


@pytest.mark.parametrize("n", [64, 128, 300])
def test_axis_taps_match_jax(n):
    rng = np.random.default_rng(n)
    p = rng.uniform(-0.5, 4 * n - 1, 200).astype(np.float32)
    p[:3] = [0.0, 4 * n - 1.0, 4 * n - 1.5]        # edges of the clip rules
    for jt, tt in [(jsd._axis_taps_up(jnp.asarray(p), 4 * n, n),
                    tsd._axis_taps_up(torch.from_numpy(p), 4 * n, n)),
                   (jsd._axis_taps_direct(jnp.asarray(p), 4 * n),
                    tsd._axis_taps_direct(torch.from_numpy(p), 4 * n))]:
        np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
        np.testing.assert_allclose(tt[1].numpy(), np.asarray(jt[1]),
                                   atol=1e-7)


def test_plain_sampler_matches_pallas_kernel():
    rng = np.random.default_rng(1)
    feats = _branches(rng)
    k, kp = 200, 256
    px, py = _coords(rng, 2, k)
    pad = ((0, 0), (0, kp - k))
    ref = pallas_sample.fused_samples_batch(
        tuple(jsd._pad_feat_cm(jnp.asarray(f)) for f in feats),
        jnp.asarray(np.pad(px, pad)), jnp.asarray(np.pad(py, pad)), H, W,
        tuple(SHAPES[1:]), interpret=True)
    np.testing.assert_allclose(_plain(feats, px, py),
                               np.asarray(ref)[:, :, :k], rtol=1e-5,
                               atol=1e-6)


def test_plain_sampler_matches_pallas_sorted_kernel():
    """The band kernel over y0-sorted keypoints, starts as the reference's
    dispatch computes them; the port samples the same sorted points."""
    rng = np.random.default_rng(2)
    feats = _branches(rng, b=1)
    k, kt, rows0 = 128, pallas_sample.KT, 80
    px, py = _coords(rng, 1, k)
    py = np.sort(np.clip(py, 20.0, 90.0), axis=1)   # one band's span
    y0 = np.clip(np.floor(py).astype(np.int32), 0, H - 2)
    starts = np.minimum((y0[:, ::kt] // 8) * 8, (H - rows0) // 8 * 8)
    ref = pallas_sample.fused_samples_sorted_batch(
        tuple(jsd._pad_feat_cm(jnp.asarray(f)) for f in feats),
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(starts), H, W,
        tuple(SHAPES[1:]), rows0=rows0, interpret=True)
    np.testing.assert_allclose(_plain(feats, px, py), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_per_map_samplers_match_jax():
    rng = np.random.default_rng(3)
    px, py = (torch.from_numpy(a[0]) for a in _coords(rng, 1, 100))
    for i, (h, w) in enumerate(SHAPES + [(2, 3)]):
        f = rng.random((h, w, 8), np.float32)
        if i == 0:
            got = tsd.sample_direct(torch.from_numpy(f), px, py)
            want = jsd.sample_direct(jnp.asarray(f), jnp.asarray(px.numpy()),
                                     jnp.asarray(py.numpy()))
        else:
            got = tsd.sample_upsampled(torch.from_numpy(f), px, py, H, W)
            want = jsd.sample_upsampled(
                jnp.asarray(f), jnp.asarray(px.numpy()),
                jnp.asarray(py.numpy()), H, W)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"branch {(h, w)}")


def _setup(size, seed, dp):
    jp = transform_params_s2d(jax_load_params("Alike"))
    tp = params_from_jax(load_npz("Alike"))
    imgs = np.random.default_rng(seed).random((2, size, size, 3), np.float32)
    score, feats = alike_s2d_feats_cm(jp, jnp.asarray(imgs))
    kpts, valid = jd.detection_batch(score[..., 0], dp)
    tfeats = tuple(torch.from_numpy(np.array(f)) for f in feats)
    return jp, tp, feats, kpts, valid, tfeats


def test_yorder_matches_jax(highest):
    h = w = 128
    dp = jd.DetectParams(nms_dist=4, border_dist=8, top_k=150)
    jp, tp, feats, kpts, valid, tfeats = _setup(h, 4, dp)
    d_ref, k_ref, v_ref = jsd.alike_sparse_descriptors_cm_batch_yorder(
        jp, tuple(feats), kpts, valid, h, w, interpret=True)
    d, k, v = tsd.alike_sparse_descriptors_cm_batch_yorder(
        tp, tfeats, torch.from_numpy(np.array(kpts)),
        torch.from_numpy(np.array(valid)), h, w)
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-5)
    keys = tsd.row_tap_keys(k, h)
    assert bool((keys[:, 1:] >= keys[:, :-1]).all())
    # the original-order API and the per-map NHWC API agree too
    d_cm = tsd.alike_sparse_descriptors_cm_batch(
        tp, tfeats, torch.from_numpy(np.array(kpts)), h, w)
    d_cm_ref = jsd.alike_sparse_descriptors_cm_batch(
        jp, tuple(feats), kpts, h, w, interpret=True)
    np.testing.assert_allclose(d_cm.numpy(), np.asarray(d_cm_ref), atol=1e-5)
    d_map = tsd.alike_sparse_descriptors(
        tp, [f[0].permute(1, 2, 0) for f in tfeats],
        torch.from_numpy(np.array(kpts[0])), h, w)
    np.testing.assert_allclose(d_map.numpy(), np.asarray(d_cm_ref[0]),
                               atol=1e-5)


def test_tiny_maps_fall_back_like_jax(highest):
    """At 64^2 the last branch is 2 x 2: the reference skips its kernel
    and samples a dense upsample, and its y-ordered API keeps the
    original order; the port does the same."""
    h = w = 64
    dp = jd.DetectParams(nms_dist=4, border_dist=4, top_k=64)
    jp, tp, feats, kpts, valid, tfeats = _setup(h, 5, dp)
    d_ref, k_ref, v_ref = jsd.alike_sparse_descriptors_cm_batch_yorder(
        jp, tuple(feats), kpts, valid, h, w, interpret=True)
    d, k, v = tsd.alike_sparse_descriptors_cm_batch_yorder(
        tp, tfeats, torch.from_numpy(np.array(kpts)),
        torch.from_numpy(np.array(valid)), h, w)
    np.testing.assert_array_equal(k.numpy(), np.asarray(kpts))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-5)


def _kernel_taps_up(p, n_hi, n_lo):
    """Kernel B's composite taps (csrc/sample.cu `taps_up`) in numpy: rows
    la, la+1, lb, lb+1 with no 4-row window, so 2- and 3-row maps work."""
    f = np.floor(p)
    dy = p - f
    s = np.float32((n_lo - 1.0) / (n_hi - 1.0))

    def lo_frac(y):
        src = y.astype(np.float32) * s
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_lo - 2)
        return lo, src - lo

    la, fa = lo_frac(f.astype(np.int64))
    lb, fb = lo_frac(np.minimum(f.astype(np.int64) + 1, n_hi - 1))
    return (np.stack([la, la + 1, lb, lb + 1], -1),
            np.stack([(1 - dy) * (1 - fa), (1 - dy) * fa, dy * (1 - fb),
                      dy * fb], -1))


@pytest.mark.parametrize("n_lo", [2, 3, 5])
def test_kernel_taps_match_dense_upsample(n_lo):
    """Kernel B samples branches of 2 and 3 rows with its composite taps,
    where the reference resizes densely (its 4-row TPU window does not
    fit): both give the sample of the align-corners upsample, within
    1e-6 (f32, other summation order)."""
    rng = np.random.default_rng(n_lo)
    f = rng.random((n_lo, n_lo + 1, 8), np.float32)
    px, py = (a[0] for a in _coords(rng, 1, 100))
    px[:2], py[:2] = [0.0, W - 1.0], [H - 1.0, 0.0]
    ri, wr = _kernel_taps_up(py, H, n_lo)
    ci, wc = _kernel_taps_up(px, W, n_lo + 1)
    got = np.einsum("ka,kb,kabc->kc", wr, wc,
                    f[ri[:, :, None], ci[:, None, :]])
    want = jsd.sample_upsampled(jnp.asarray(f), jnp.asarray(px),
                                jnp.asarray(py), H, W)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        tsd.sample_upsampled(torch.from_numpy(f), torch.from_numpy(px),
                             torch.from_numpy(py), H, W).numpy(),
        np.asarray(want), atol=1e-6)
