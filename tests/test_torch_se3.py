"""The SE3 pieces of the AUC slice in the PyTorch port vs the JAX reference
(CPU): the numpy `rodrigues` against cv2.Rodrigues, SyntheticSE3Dataset
and SyntheticSplatSequenceDataset against the JAX datasets, and the SE3
warp (`_interp_depth`, `warp_se3`, `warp_dense`) against the JAX warp.

Tolerances: rodrigues within 1e-12 of cv2; dataset images, depths and
frames within 1e-6 of the JAX package's (they come out equal); depths
interpolated within 1e-5 and warped pixels within 1e-5 px plus 1e-6 of
the coordinate, with equal validity masks. The relative term is about
eight float32 ulps: the chain of 3 x 3 products, unprojection and
projection sums in another order than XLA's, and a coordinate above 128 px
moves by one ulp (1.5e-5 px) already at its last product. The port's datasets build with cv2 blocked.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.datasets import synthetic as jsyn
from keypoint_bench_tpu.geometry import warp as jw
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.datasets import synthetic as tsyn
from keypoint_bench_tpu_torch.geometry import warp as tw


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128


@pytest.fixture(scope="module")
def item():
    return tsyn.SyntheticSE3Dataset(2, S, 0, 200)[1]


@pytest.mark.parametrize("angle", [0.0, 1e-20, 1e-9, 1e-3, 0.03, 1.0, 3.1])
def test_rodrigues_matches_cv2(angle):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(int(angle * 1e3) + 1)
    for _ in range(20):
        aa = rng.normal(size=3)
        aa *= angle / np.linalg.norm(aa)
        np.testing.assert_allclose(tsyn.rodrigues(aa), cv2.Rodrigues(aa)[0],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("idx", [0, 1])
def test_se3_dataset_matches_jax(idx):
    got = tsyn.SyntheticSE3Dataset(2, S, 0, 200)[idx]
    want = jsyn.SyntheticSE3Dataset(2, S, 0, 200)[idx]
    for k in ("image0", "image1"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    assert got["dataset"] == want["dataset"]
    for wp in ("warp01_params", "warp10_params"):
        assert sorted(got[wp]) == sorted(want[wp])
        for k, v in want[wp].items():
            if isinstance(v, str):
                assert got[wp][k] == v
                continue
            assert np.asarray(got[wp][k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_allclose(got[wp][k], v, rtol=0, atol=1e-6,
                                       err_msg=f"{wp}.{k}")


def test_splat_sequence_frames_unchanged():
    got = tsyn.SyntheticSplatSequenceDataset(3, 64, 0, 100)
    want = jsyn.SyntheticSplatSequenceDataset(3, 64, 0, 100)
    for i in range(3):
        for k in ("image0", "ground_truth", "fundamental"):
            np.testing.assert_allclose(got[i][k], want[i][k], rtol=0,
                                       atol=1e-6)


def test_datasets_build_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    se3 = get_dataset({"type": "synthetic_se3", "num_pairs": 1,
                       "image_size": 64})
    assert se3[0]["image0"].shape == (64, 64, 3)
    seq = get_dataset({"type": "synthetic_splat_sequence", "num_frames": 2,
                       "image_size": 64})
    assert seq[1]["image0"].shape == (64, 64, 3)


def _points(item, n=400, seed=0):
    """Random keypoints plus keypoints in the 10-px border band, and a
    depth0 with a zeroed patch under some of them."""
    rng = np.random.default_rng(seed)
    band = np.r_[rng.uniform(0, 10, 40), rng.uniform(S - 11, S, 40)] / S
    pts = np.r_[rng.random((n, 2)),
                np.c_[band, rng.random(80)], np.c_[rng.random(80), band],
                rng.uniform(40, 60, (40, 2)) / S]
    kp = np.c_[pts, rng.random(len(pts))].astype(np.float32)
    valid = rng.random(len(pts)) > 0.05
    wp = dict(item["warp01_params"])
    depth0 = wp["depth0"].copy()
    depth0[45:56, 45:56] = 0.0
    wp["depth0"] = depth0
    return kp, valid, wp


def _px(a, scale):
    return np.asarray(a, np.float64) * scale


def test_interp_depth_matches_jax(item):
    kp, _, wp = _points(item)
    p = kp[:, :2] * S
    z, v = tw._interp_depth(torch.from_numpy(p), torch.from_numpy(
        wp["depth0"]))
    zr, vr = jw._interp_depth(jnp.asarray(p), jnp.asarray(wp["depth0"]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), rtol=0, atol=1e-5)
    assert 0 < int(v.sum()) < len(v)


def test_warp_se3_matches_jax_with_border_zero_depth_and_occlusion(item):
    kp, valid, wp = _points(item)
    got = tw.warp_points(torch.from_numpy(kp), torch.from_numpy(valid), wp)
    want = jw.warp_points(jnp.asarray(kp), jnp.asarray(valid), wp)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_px(g, S), _px(w, S), rtol=1e-6,
                                   atol=1e-5)
    # every rule takes some points out: the border band, zero depth, and
    # the occlusion test (both depths valid, the projected depth off)
    p0 = jnp.asarray(kp[:, :2] * S)
    _, v0 = jw._interp_depth(p0, jnp.asarray(wp["depth0"]))
    z0, _ = jw._interp_depth(p0, jnp.asarray(wp["depth0"]), border=0)
    uv1 = jnp.asarray(np.asarray(want[1]) * S)
    _, v1 = jw._interp_depth(uv1, jnp.asarray(wp["depth1"]))
    out = ~np.asarray(want[2]) & valid
    border = np.any((kp[:, :2] * S < 10) | (kp[:, :2] * S > S - 11), axis=1)
    assert (out & border).any()
    assert (out & (np.asarray(z0) == 0)).any()
    assert (out & np.asarray(v0) & np.asarray(v1)).any()


@pytest.mark.parametrize("direction", ["warp01_params", "warp10_params"])
def test_warp_dense_matches_jax(item, direction):
    """Every pixel centre; the warped coordinates compared on the valid
    rows (an invalid row's warp is never read: the reference drops it)."""
    got = tw.warp_dense(S, S, item[direction])
    want = jw.warp_dense(S, S, item[direction])
    ok = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), ok)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(_px(got[1], S)[ok], _px(want[1], S)[ok],
                               rtol=1e-6, atol=1e-5)
    assert 0.3 < float(got[2].float().mean()) < 1.0


def test_warp_se3_takes_batch_dims(item):
    kp, valid, wp = _points(item)
    one = tw.warp_points(torch.from_numpy(kp), torch.from_numpy(valid), wp)
    stacked = {k: (np.stack([v, v]) if isinstance(v, np.ndarray) else v)
               for k, v in wp.items()}
    two = tw.warp_points(torch.from_numpy(np.stack([kp, kp])),
                         torch.from_numpy(np.stack([valid, valid])), stacked)
    for a, b in zip(one, two):
        assert torch.equal(b[0], a) and torch.equal(b[1], a)
