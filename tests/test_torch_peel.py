"""The per-chunk candidate peel and the fused detection path in the PyTorch
port vs the JAX reference (CPU; the JAX side runs its Pallas kernels in
interpret mode).

Tolerance: none. The peel only compares, selects and masks, so values and
indices must equal `fast_nms_topk_pallas` bit for bit, and
`detection_batch_fused` must return the keypoints and masks of both the JAX
`_detection_batch_fused` and the port's own `detection_batch`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from keypoint_bench_tpu.ops import detect as jd
from keypoint_bench_tpu.ops.pallas_nms import fast_nms_topk_pallas
from keypoint_bench_tpu_torch.ops import cuda_nms
from keypoint_bench_tpu_torch.ops import detect as td


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _maps(kind, shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.random(shape).astype(np.float32)
    if kind == "smooth":
        return ndi.gaussian_filter(base, (0, 2.0, 2.0))
    if kind == "tie_bf16":
        # bf16-rounded values collapse into few distinct ones
        m = ndi.gaussian_filter(base, (0, 1.0, 1.0))
        return np.array(jnp.asarray(m, jnp.bfloat16).astype(jnp.float32))
    # sparse: most chunks hold fewer than 8 non-zero entries
    return np.where(base > 0.97, base, 0.0).astype(np.float32)


CASES = [("smooth", (3, 64, 128), 4, 8, 11), ("tie_bf16", (2, 64, 128), 2, 4,
                                              12),
         ("sparse", (2, 32, 256), 2, 3, 13), ("smooth", (1, 40, 384), 3, 0,
                                              14)]


@pytest.mark.parametrize("kind,shape,d,border,seed", CASES)
def test_peel_matches_pallas_interpret(kind, shape, d, border, seed):
    maps = _maps(kind, shape, seed)
    nms, v, i = cuda_nms.fast_nms_topk(torch.from_numpy(maps), d, 30, border,
                                       8)
    for b in range(shape[0]):
        jn, jv, ji = fast_nms_topk_pallas(jnp.asarray(maps[b]), d, 30, border,
                                          8, interpret=True)
        np.testing.assert_array_equal(nms[b].numpy(), np.asarray(jn))
        np.testing.assert_array_equal(v[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i[b].numpy(), np.asarray(ji))
    assert v.dtype == torch.float32 and i.dtype == torch.int32


@pytest.mark.parametrize("per_chunk", [1, 5, 8])
def test_peel_order_and_exhaustion(per_chunk):
    """Value descending, lowest column first on ties, global columns; a
    chunk that runs out of finite values yields -inf."""
    m = np.zeros((1, 20, 256), np.float32)
    m[0, 9, 130] = m[0, 9, 140] = m[0, 9, 200] = 0.5     # ties in chunk 1
    m[0, 9, 135] = 0.7
    v, i = td.peel_topk(torch.from_numpy(m), 4, per_chunk)
    row_v = v[0, 9, per_chunk:].numpy()
    row_i = i[0, 9, per_chunk:].numpy()
    want_v = [0.7, 0.5, 0.5, 0.5, 0.0, 0.0, 0.0, 0.0][:per_chunk]
    want_i = [135, 130, 140, 200, 128, 129, 131, 132][:per_chunk]
    np.testing.assert_array_equal(row_v, np.float32(want_v))
    np.testing.assert_array_equal(row_i, want_i)


def test_peel_runs_out_of_finite_values():
    """A chunk with fewer finite values than rounds yields -inf at its
    lowest -inf columns, as the TPU kernel's masking does."""
    import functools

    import jax
    from jax.experimental import pallas as pl

    from keypoint_bench_tpu.ops.pallas_nms import _peel_kernel
    m = np.full((8, 128), -np.inf, np.float32)
    m[:, 40] = 0.25
    m[3, 7] = 0.5
    m[3, 90] = 0.25
    v, i = td.peel_topk(torch.from_numpy(m)[None], 0, 4)
    jv, ji = pl.pallas_call(
        functools.partial(_peel_kernel, border=0, per_chunk=4),
        out_shape=(jax.ShapeDtypeStruct((8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((8, 128), jnp.int32)),
        interpret=True)(jnp.asarray(m))
    np.testing.assert_array_equal(v[0].numpy(), np.asarray(jv)[:, :4])
    np.testing.assert_array_equal(i[0].numpy(), np.asarray(ji)[:, :4])
    np.testing.assert_array_equal(v[0, 3].numpy(),
                                  np.float32([0.5, 0.25, 0.25, -np.inf]))
    np.testing.assert_array_equal(i[0, 3].numpy(), [7, 40, 90, 0])


def _detect_both(maps, dp_kw, dtype=None):
    jm = jnp.asarray(maps) if dtype is None else jnp.asarray(maps, dtype)
    tm = torch.from_numpy(np.array(jm.astype(jnp.float32)))
    if dtype is not None:
        tm = tm.to(torch.bfloat16)
    jk, jv = jd._detection_batch_fused(jm, jd.DetectParams(**dp_kw),
                                       interpret=True)
    tp = td.DetectParams(**dp_kw)
    fk, fv = td.detection_batch_fused(tm, tp)
    pk, pv = td.detection_batch(tm, tp)
    return (np.asarray(jk), np.asarray(jv)), (fk.numpy(), fv.numpy()), \
        (pk.numpy(), pv.numpy())


def test_fused_detection_matches_jax_and_unfused():
    maps = _maps("smooth", (3, 64, 128), 11)
    j, f, p = _detect_both(maps, dict(nms_dist=4, border_dist=8, top_k=100))
    np.testing.assert_array_equal(f[0], j[0])
    np.testing.assert_array_equal(f[1], j[1])
    np.testing.assert_array_equal(f[0], p[0])
    np.testing.assert_array_equal(f[1], p[1])


def test_fused_detection_tie_heavy_bf16_takes_the_full_sort():
    rng = np.random.default_rng(12)
    maps = ndi.gaussian_filter(rng.random((2, 64, 128)).astype(np.float32),
                               (0, 1.0, 1.0))
    kw = dict(nms_dist=2, border_dist=4, top_k=200)
    j, f, p = _detect_both(maps, kw, jnp.bfloat16)
    np.testing.assert_array_equal(f[0], j[0])
    np.testing.assert_array_equal(f[1], j[1])
    np.testing.assert_array_equal(f[0], p[0])
    np.testing.assert_array_equal(f[1], p[1])
    tm = torch.from_numpy(maps).to(torch.bfloat16)
    *_, unsafe = td.fused_topk(tm, td.DetectParams(**kw), 200)
    assert unsafe
    smooth = torch.from_numpy(_maps("smooth", (3, 64, 128), 11))
    *_, unsafe = td.fused_topk(
        smooth, td.DetectParams(nms_dist=4, border_dist=8, top_k=100), 100)
    assert not unsafe


def test_fused_detection_hands_over_when_k_exceeds_candidates():
    """top_k above H * n_blk * per_chunk: the unfused path's result (the
    JAX package's shape rule)."""
    maps = torch.from_numpy(_maps("smooth", (2, 16, 128), 15))
    dp = td.DetectParams(nms_dist=2, border_dist=2, top_k=200)
    fk, fv = td.detection_batch_fused(maps, dp)         # 200 > 16 * 8
    pk, pv = td.detection_batch(maps, dp)
    np.testing.assert_array_equal(fk.numpy(), pk.numpy())
    np.testing.assert_array_equal(fv.numpy(), pv.numpy())
    assert fk.shape[1] == 200


@pytest.mark.parametrize("shape,per_chunk,d", [((1, 32, 100), 8, 4),
                                               ((1, 32, 2176), 8, 4),
                                               ((1, 32, 128), 8, 0)])
def test_fused_shape_rules_raise(shape, per_chunk, d):
    """w % 128 != 0, more than 128 candidates per row and nms_dist == 0
    raise, as in the JAX package."""
    maps = torch.zeros(shape)
    with pytest.raises(ValueError):
        cuda_nms.fast_nms_topk(maps, d, 30, 4, per_chunk)
    with pytest.raises(ValueError):
        fast_nms_topk_pallas(jnp.zeros(shape[1:]), d, 30, 4, per_chunk,
                             interpret=True)
    dp = td.DetectParams(nms_dist=d, border_dist=4, top_k=10)
    if shape[2] < 128:
        # no chunk, so no candidate: the hand-over rule comes first
        assert td.detection_batch_fused(maps, dp, per_chunk)[0].shape[1] == 10
    else:
        with pytest.raises(ValueError):
            td.detection_batch_fused(maps, dp, per_chunk)


def test_peel_cuda_refuses_cpu_tensors():
    with pytest.raises((ValueError, RuntimeError)):
        cuda_nms.peel_cuda(torch.zeros(1, 8, 128), 2, 8)
