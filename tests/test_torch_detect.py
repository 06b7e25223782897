"""Detection in the PyTorch port vs the JAX reference (CPU).

Tolerance: none. The NMS fixpoint only compares and selects, so the port's
`fast_nms` must equal the JAX `fast_nms` and the Pallas kernel
(`fast_nms_pallas`, interpret mode) bit for bit, in f32 and on bf16 maps;
detection keypoints (x, y, score) and masks must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu.ops.pallas_nms import fast_nms_pallas
from keypoint_bench_tpu_torch.ops import detect as td


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _map(kind, shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.random(shape).astype(np.float32)
    if kind == "smooth":
        return ndi.gaussian_filter(base, (0,) * (len(shape) - 2) + (2.0, 2.0))
    if kind == "random":
        return base
    if kind == "tie_bf16":
        # few distinct values: many equal neighbours exercise the tie split
        return np.round(ndi.gaussian_filter(base, 1.0) * 8) / 8
    # signed: negative values sit below the zero padding
    return ndi.gaussian_filter(base - 0.5, 2.0)


def _pair(kind, shape, seed):
    m = _map(kind, shape, seed)
    if kind in ("tie_bf16", "signed"):
        j = jnp.asarray(m, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(m), torch.from_numpy(m)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("d", [2, 4, 6])
@pytest.mark.parametrize("kind", ["smooth", "random", "tie_bf16", "signed"])
def test_fast_nms_bit_exact(kind, d):
    j, t = _pair(kind, (48, 64), 10 * d + len(kind))
    got = td.fast_nms(t, d, 30)
    assert got.dtype == t.dtype
    want = np.asarray(jd.fast_nms(j, d, 30).astype(jnp.float32))
    want_pallas = np.asarray(
        fast_nms_pallas(j, d, 30, interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), want_pallas)


def test_fast_nms_batch_freezes_each_map():
    """[B,H,W] maps stop on their own, as vmap(fast_nms) does; max_iter
    caps the rounds."""
    maps = np.stack([_map("smooth", (48, 64), 1), _map("random", (48, 64), 2),
                     _map("smooth", (48, 64), 3) * 0.5])
    for max_iter in (1, 3, 30):
        want = np.asarray(jax.vmap(lambda m: jd.fast_nms(m, 4, max_iter))(
            jnp.asarray(maps)))
        got, rounds = td.fast_nms_rounds(torch.from_numpy(maps), 4, max_iter)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(rounds.max()) <= max_iter
    assert len(set(rounds.tolist())) > 1, "maps should converge separately"


def _check_detection(maps, dp_kwargs):
    jdp = jd.DetectParams(**dp_kwargs)
    tdp = td.DetectParams(**dp_kwargs)
    jm = jnp.asarray(maps)
    k_ref, v_ref = jd.detection_batch(jm, jdp)
    k, v = td.detection_batch(torch.from_numpy(np.array(maps)), tdp)
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    for i in range(maps.shape[0]):
        k1, v1 = td.detection(torch.from_numpy(np.array(maps[i])), tdp)
        k1r, v1r = jd.detection(jm[i], jdp)
        np.testing.assert_array_equal(k1.numpy(), np.asarray(k1r))
        np.testing.assert_array_equal(v1.numpy(), np.asarray(v1r))


@pytest.mark.parametrize("kind,dp", [
    ("smooth", dict(nms_dist=4, border_dist=8, top_k=100)),
    ("random", dict(nms_dist=2, border_dist=4, top_k=200, threshold=0.5)),
    ("smooth", dict(nms_dist=6, border_dist=8, top_k=1000, min_score=0.3)),
])
def test_detection_batch_matches_jax(kind, dp):
    # 64 x 128 = 8192 pixels: the JAX top-k takes its chunked candidate
    # path there (n > 4 * 128), not only the full sort
    maps = np.stack([_map(kind, (64, 128), s) for s in (5, 6)])
    _check_detection(maps, dp)


def test_detection_tie_fallback_matches_jax():
    """A map of few distinct values makes the JAX chunked top-k unsafe, so
    it falls back to its stable sort; the port's one stable sort must
    give the same (value desc, index asc) order."""
    maps = np.stack([_map("tie_bf16", (64, 128), s) for s in (7, 8)])
    dp = dict(nms_dist=1, border_dist=2, top_k=300)
    flat = jnp.asarray(jd.remove_border(
        jd.fast_nms(jnp.asarray(maps[0]), 1, 30), 2).reshape(-1))
    assert bool(jd._topk_candidates(flat, 300)[2]), "fallback not forced"
    _check_detection(maps, dp)


def test_topk_and_border_match_jax():
    rng = np.random.default_rng(9)
    flat = rng.integers(0, 5, 1000).astype(np.float32)
    v_ref, i_ref = jd._topk_stable_sort(jnp.asarray(flat), 50)
    v, i = td.topk_select(torch.from_numpy(flat), 50)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    m = rng.random((20, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        td.remove_border(torch.from_numpy(m), 3).numpy(),
        np.asarray(jd.remove_border(jnp.asarray(m), 3)))
