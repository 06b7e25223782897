"""bf16 mode's samplers, matching and detection in the port vs the JAX
reference (CPU). Maps and descriptors are numpy f32 draws rounded to bf16
on each side (both round to nearest even, checked below).

- Kernel B's plain version on bf16 branch maps against the Pallas
  `fused_samples_batch` / `fused_samples_sorted_batch` in interpret mode:
  both round each merged column tap weight to bf16, keep the row weights
  f32 and sum exact products in f32, in other orders: within 1e-5 of the
  output's largest magnitude. On the 2- and 3-row maps that the TPU kernel
  cannot take (the reference resizes them densely in f32) the port keeps
  the kernel's rounding: held to the dense f32 result within the weight
  rounding, 2^-8 relative.
- The per-map samplers against JAX's "mm" sampler (bf16 row and column
  weights, the row contraction stored in bf16): a stored bf16 value may
  round the other way where the two f32 sums part, so within one bf16 ulp
  (2^-7 relative) of the largest output.
- `sample_at_points` of a bf16 map: f32 arithmetic on the bf16 values on
  both sides, within 1e-6.
- Mutual NN on bf16 descriptors: exact products, f32 sums in other
  orders; indices and masks equal except on rows whose best and second
  distances lie within 1e-5 relative (near ties, none expected here).
- Detection on bf16 score maps, whose sigmoid values collapse into ties:
  keypoints equal (the lowest index first among equal scores).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu.ops import grid_sample as jgs
from keypoint_bench_tpu.ops import matching as jm
from keypoint_bench_tpu.ops import pallas_sample
from keypoint_bench_tpu.ops import sparse_desc as jsd
from keypoint_bench_tpu_torch.ops import cuda_match, cuda_sample
from keypoint_bench_tpu_torch.ops import detect as td
from keypoint_bench_tpu_torch.ops import grid_sample as tgs
from keypoint_bench_tpu_torch.ops import matching as tm
from keypoint_bench_tpu_torch.ops import sparse_desc as tsd


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
BF = torch.bfloat16


def _bf16_pair(a: np.ndarray):
    """(jnp bf16, torch bf16) of one f32 array; the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(a).to(BF)
    np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                  t.float().numpy())
    return j, t


def _branches(rng, shapes, b=2, c=16):
    return [_bf16_pair(rng.random((b, c, h, w), np.float32))
            for h, w in shapes]


def _coords(rng, b, k, h=H, w=W):
    px = rng.uniform(0, w - 1.001, (b, k)).astype(np.float32)
    py = rng.uniform(0, h - 1.001, (b, k)).astype(np.float32)
    return px, py


def _plain(tfeats, px, py, h=H, w=W):
    return tsd.sample_branches(tuple(tfeats), torch.from_numpy(px),
                               torch.from_numpy(py), h, w).numpy()


def _assert_rel(got, ref, rel):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def test_plain_sampler_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(1)
    feats = _branches(rng, SHAPES)
    k, kp = 200, 256
    px, py = _coords(rng, 2, k)
    pad = ((0, 0), (0, kp - k))
    ref = pallas_sample.fused_samples_batch(
        tuple(jsd._pad_feat_cm(j) for j, _ in feats),
        jnp.asarray(np.pad(px, pad)), jnp.asarray(np.pad(py, pad)), H, W,
        tuple(SHAPES[1:]), interpret=True)
    got = _plain([t for _, t in feats], px, py)
    assert got.dtype == np.float32
    _assert_rel(got, np.asarray(ref)[:, :, :k], 1e-5)
    # the rounding is the kernel's: the f32 sampler on the same values
    # parts from it by up to the bf16 weight rounding
    f32 = _plain([t.float() for _, t in feats], px, py)
    gap = np.abs(f32 - got).max() / np.abs(got).max()
    assert 1e-5 < gap < 2.0 ** -7


def test_plain_sampler_bf16_matches_pallas_sorted_kernel():
    rng = np.random.default_rng(2)
    feats = _branches(rng, SHAPES, b=1)
    k, kt, rows0 = 128, pallas_sample.KT, 80
    px, py = _coords(rng, 1, k)
    py = np.sort(np.clip(py, 20.0, 90.0), axis=1)
    y0 = np.clip(np.floor(py).astype(np.int32), 0, H - 2)
    starts = np.minimum((y0[:, ::kt] // 8) * 8, (H - rows0) // 8 * 8)
    ref = pallas_sample.fused_samples_sorted_batch(
        tuple(jsd._pad_feat_cm(j) for j, _ in feats),
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(starts), H, W,
        tuple(SHAPES[1:]), rows0=rows0, interpret=True)
    _assert_rel(_plain([t for _, t in feats], px, py), np.asarray(ref), 1e-5)


@pytest.mark.parametrize("n_hi,n_lo", [(512, 256), (512, 64), (512, 16),
                                       (128, 64), (128, 4), (96, 3),
                                       (64, 2)])
def test_merged_taps_equal_composite_taps(n_hi, n_lo):
    """Kernel B's merged rows la..la+2 carry the composite taps' weights
    exactly (f32), so both round to the same bf16 column weights."""
    rng = np.random.default_rng(n_hi + n_lo)
    p = torch.from_numpy(rng.uniform(0, n_hi - 1.001, 300).astype(
        np.float32))
    p[:3] = torch.tensor([0.0, n_hi - 1.0, n_hi - 1.5])
    base, wm = tsd._axis_taps_merged(p, n_hi, n_lo)
    dense = torch.zeros(len(p), n_lo + 2)
    dense.scatter_add_(1, base[:, None] + torch.arange(3), wm)
    assert (dense[:, n_lo:] == 0).all()
    if n_lo >= 4:
        b4, w4 = tsd._axis_taps_up(p, n_hi, n_lo)
        ref = torch.zeros(len(p), n_lo + 2)
        ref.scatter_add_(1, b4[:, None] + torch.arange(4), w4)
        assert torch.equal(dense, ref)
    else:
        torch.testing.assert_close(dense.sum(1), torch.ones(len(p)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [64, 96])
def test_plain_sampler_bf16_on_tiny_branches(size):
    """ALIKE at 64^2 and 96^2 has 2- and 3-row last branches, which the TPU
    kernel does not take; the port's bf16 sampler keeps the kernel's
    rounding there: within 2^-8 of the f32 composite samples (the
    reference's dense fallback) on the same values."""
    shapes = [(size, size), (size // 2, size // 2), (size // 8, size // 8),
              (size // 32, size // 32)]
    rng = np.random.default_rng(size)
    feats = _branches(rng, shapes)
    px, py = _coords(rng, 2, 100, size, size)
    got = _plain([t for _, t in feats], px, py, size, size)
    ref = _plain([t.float() for _, t in feats], px, py, size, size)
    _assert_rel(got, ref, 2.0 ** -8)


def test_per_map_samplers_bf16_match_jax_mm():
    rng = np.random.default_rng(3)
    px, py = _coords(rng, 1, 100)
    jx, jy = jnp.asarray(px[0]), jnp.asarray(py[0])
    tx, ty = torch.from_numpy(px[0]), torch.from_numpy(py[0])
    for i, (h, w) in enumerate(SHAPES + [(2, 3)]):
        jf, tf = _bf16_pair(rng.random((h, w, 8), np.float32))
        if i == 0:
            got = tsd.sample_direct(tf, tx, ty)
            want = jsd.sample_direct(jf, jx, jy)
        else:
            got = tsd.sample_upsampled(tf, tx, ty, H, W)
            want = jsd.sample_upsampled(jf, jx, jy, H, W)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _assert_rel(got.numpy(), np.asarray(want), 2.0 ** -7)


def test_sample_at_points_bf16_matches_jax():
    rng = np.random.default_rng(4)
    jm_, tm_ = _bf16_pair(rng.standard_normal((16, 20, 64)).astype(
        np.float32))
    k = rng.random((300, 3)).astype(np.float32)
    want = jgs.sample_at_points(jm_, jnp.asarray(k))
    got = tgs.sample_at_points(tm_, torch.from_numpy(k))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _descs(seed, m=300, n=320, d=64):
    """bf16 descriptors (normalized normals) with planted near copies."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    c = 2 * min(m, n) // 3
    b[:c] = a[:c] + 0.05 * rng.standard_normal((c, d))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    va, vb = rng.random(m) > 0.1, rng.random(n) > 0.1
    return _bf16_pair(a), _bf16_pair(b), va, vb


def _near_ties(a, b, va, vb, rel=1e-5):
    """Valid rows whose best and second valid distances (f64) lie within
    rel."""
    d = ((a[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1)
    two = np.sort(d[:, vb], axis=1)[:, :2]
    return va & (two[:, 1] - two[:, 0] <= rel * two[:, 0])


@pytest.mark.parametrize("max_distance", [0.5, 5.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_mutual_nn_bf16_matches_jax(seed, max_distance):
    (ja, ta), (jb, tb), va, vb = _descs(seed)
    nn_ref, ok_ref = jm.mutual_nn_match(ja, jb, jnp.asarray(va),
                                        jnp.asarray(vb), max_distance)
    keep = ~_near_ties(ta.float().numpy(), tb.float().numpy(), va, vb)
    keep &= va
    for fn in (tm.mutual_nn_match, tm.mutual_nn_fused):
        nn, ok = fn(ta, tb, torch.from_numpy(va), torch.from_numpy(vb),
                    max_distance)
        np.testing.assert_array_equal(nn.numpy()[keep],
                                      np.asarray(nn_ref)[keep])
        np.testing.assert_array_equal(ok.numpy()[keep],
                                      np.asarray(ok_ref)[keep])
        assert int(ok.sum()) == int(ok_ref.sum()) > 20


def test_mutual_nn_bf16_reaches_kernel_d_as_exact_f32(monkeypatch):
    """bf16 descriptors go to kernel D's entry point upcast (exact) with
    the penalty feature in f32: sqrt(1e8) = 1e4 exactly, which bf16 would
    make 9984."""
    (_, ta), (_, tb), va, vb = _descs(2, m=2 * 50, n=2 * 60)
    a, b = ta.reshape(2, 50, 64), tb.reshape(2, 60, 64)
    va = torch.from_numpy(va).reshape(2, 50)
    vb = torch.from_numpy(vb).reshape(2, 60)
    seen = []

    def spy(x, y):
        seen.append((x, y))
        return tm.nn_dists(x, y)
    monkeypatch.setattr(cuda_match, "nearest_neighbours", spy)
    got = tm.mutual_nn_fused(a, b, va, vb, 5.0)
    (x, y), = seen
    assert x.dtype == y.dtype == torch.float32
    assert torch.equal(x[..., :-1], a.float())
    assert torch.equal(y[..., :-1], b.float())
    assert float(x[..., -1].max()) == 1e4 != float(
        torch.tensor(1e4).to(BF))
    want = tm.mutual_nn_fused(a.float(), b.float(), va, vb, 5.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bf16_kernels_are_their_own_entry_points():
    """bf16 maps go to kernel B's bf16 instantiation, which counts its
    own launches (`chip_smoke.py` reports it as B-bf16); kernel D has one
    instantiation, fed the exact f32 upcast."""
    assert cuda_sample._KERNELS[BF] is cuda_sample.KERNEL_BF16
    assert cuda_sample._KERNELS[torch.float32] is cuda_sample.KERNEL
    assert cuda_sample.KERNEL_BF16.symbol == "kbt_sample_bf16"
    assert cuda_sample.KERNEL_BF16.lib_name == "sample"
    assert not hasattr(cuda_match, "KERNEL_BF16")


def _tied_maps(seed, b=2, h=96, w=128):
    """bf16 sigmoid maps of smooth logits: few distinct values, many
    ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h // 8, w // 8)).astype(np.float32) * 4
    x = np.kron(x, np.ones((8, 8), np.float32))
    x += rng.standard_normal((b, h, w)).astype(np.float32)
    return _bf16_pair(1 / (1 + np.exp(-x)))


@pytest.mark.parametrize("nms_dist", [0, 3, 6])
def test_detection_bf16_maps_match_jax(nms_dist):
    (jmap, tmap) = _tied_maps(nms_dist)
    vals = np.unique(tmap.float().numpy())
    assert len(vals) < 0.1 * tmap.numel()           # ties everywhere
    assert int((tmap == tmap.max()).sum()) > 20     # at the top too
    dp = dict(nms_dist=nms_dist, border_dist=8, top_k=300)
    k_ref, v_ref = jd.detection_batch(jmap, jd.DetectParams(**dp))
    k, v = td.detection_batch(tmap, td.DetectParams(**dp))
    assert k.dtype == torch.float32
    # positions as pixels (x = (col + 0.5) / W computes to within an ulp
    # on both sides) and scores, exactly
    k, k_ref = k.numpy(), np.asarray(k_ref)
    size = np.array([tmap.shape[2], tmap.shape[1]])
    np.testing.assert_array_equal(np.round(k[..., :2] * size - 0.5),
                                  np.round(k_ref[..., :2] * size - 0.5))
    np.testing.assert_array_equal(k[..., 2], k_ref[..., 2])
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    k = torch.from_numpy(k)
    fused = td.detection_batch_fused(tmap, td.DetectParams(**dp)) \
        if nms_dist else (k, v)
    np.testing.assert_array_equal(fused[0].numpy(), k.numpy())
