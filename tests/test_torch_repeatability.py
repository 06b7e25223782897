"""Warps, grid sampling, the synthetic dataset and repeatability in the
PyTorch port vs the JAX reference (CPU).

Tolerances: warped coordinates 1e-6 (a 3x3 f32 product, summed in another
order); masks, counts and the dataset's images and homographies exact;
repeatability (a ratio of counts) 1e-7; the mean error, a mean of
scaled f32 distances, rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.datasets.synthetic import \
    SyntheticHomographyDataset as JaxDataset
from keypoint_bench_tpu.geometry import warp as jw
from keypoint_bench_tpu.ops import grid_sample as jgs
from keypoint_bench_tpu.tasks.repeatability import repeatability_pair as jrep
from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.geometry import warp as tw
from keypoint_bench_tpu_torch.ops import grid_sample as tgs
from keypoint_bench_tpu_torch.tasks.repeatability import \
    repeatability_pair as trep


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128


def _homography(seed):
    return get_dataset({"type": "synthetic_homography", "num_pairs": 1,
                        "image_size": S, "seed": seed})[0]


def test_synthetic_dataset_is_the_reference_copy():
    ours = get_dataset({"type": "synthetic_homography", "num_pairs": 2,
                        "image_size": 64, "seed": 3})
    ref = JaxDataset(2, 64, 3)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a["image0"], b["image0"])
        np.testing.assert_array_equal(a["image1"], b["image1"])
        for wp in ("warp01_params", "warp10_params"):
            np.testing.assert_array_equal(a[wp]["homography_matrix"],
                                          b[wp]["homography_matrix"])
            assert a[wp]["mode"] == b[wp]["mode"] == "homo"


def _kpts(seed, k=80):
    rng = np.random.default_rng(seed)
    kp = np.stack([rng.random(k), rng.random(k), rng.random(k)],
                  -1).astype(np.float32)
    return kp, rng.random(k) > 0.1


def test_warp_homography_matches_jax():
    sample = _homography(1)
    kp, valid = _kpts(2)
    for wp in (sample["warp01_params"], sample["warp10_params"]):
        ref = jw.warp_points(jnp.asarray(kp), jnp.asarray(valid),
                             {**wp, "homography_matrix":
                              jnp.asarray(wp["homography_matrix"])})
        got = tw.warp_points(torch.from_numpy(kp), torch.from_numpy(valid),
                             wp)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        assert 0 < int(got[2].sum()) < len(kp)


def _rep_inputs(case):
    sample = _homography(4)
    kp0, v0 = _kpts(5)
    kp1, v1 = _kpts(6, k=70)
    if case == "diag":
        # kp1 = the exact warp of central kp0, all valid and covisible:
        # every true pair sits on the compacted diagonal, which the
        # reference masks with 99999
        kp0 = kp0[:70]
        kp0[:, :2] = 0.3 + 0.4 * kp0[:, :2]
        v0 = v1 = np.ones(70, bool)
        h = sample["warp01_params"]["homography_matrix"]
        q = np.c_[kp0[:, :2] * (S - 1.0), np.ones(70)] @ h.T
        kp1[:, :2] = q[:, :2] / q[:, 2:] / (S - 1.0)
    elif case == "empty":
        kp1[:, :2] = 0.0
        kp1[:, :2] += 2.0           # every warped point leaves the image
    return sample, kp0, v0, kp1, v1


@pytest.mark.parametrize("case", ["random", "diag", "empty"])
def test_repeatability_pair_matches_jax(case):
    sample, kp0, v0, kp1, v1 = _rep_inputs(case)
    wp01, wp10 = sample["warp01_params"], sample["warp10_params"]

    def run(mod_warp, rep, conv, jax_side):
        def fix(wp):
            return ({**wp, "homography_matrix":
                     jnp.asarray(wp["homography_matrix"])} if jax_side
                    else wp)
        k0, va0, k1, va1 = (conv(x) for x in (kp0, v0, kp1, v1))
        a = mod_warp.warp_points(k0, va0, fix(wp01))
        b = mod_warp.warp_points(k1, va1, fix(wp10))
        return rep(k0, va0, k1, va1, *a, *b, float(S), 3.0)

    ref = run(jw, jrep, jnp.asarray, True)
    got = run(tw, trep, torch.from_numpy, False)
    for key in ("num_feat", "gt_num"):
        assert int(got[key]) == int(ref[key]), key
    np.testing.assert_allclose(float(got["repeatability"]),
                               float(ref["repeatability"]), atol=1e-7)
    np.testing.assert_allclose(float(got["mean_error"]),
                               float(ref["mean_error"]), rtol=1e-5,
                               equal_nan=True)
    if case == "empty":
        assert float(got["repeatability"]) == 0.0
        assert int(got["num_feat"]) == 0
    if case == "diag":
        # without the quirk all 70 true pairs would hit; with it only
        # neighbours that happen to lie within 3 px remain
        assert int(got["gt_num"]) < 35


def test_sample_bilinear_pixels_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.random((10, 12, 3), np.float32)
    px = rng.uniform(-1.5, 12.5, 200).astype(np.float32)
    py = rng.uniform(-1.5, 10.5, 200).astype(np.float32)
    got = tgs.sample_bilinear_pixels(torch.from_numpy(img),
                                     torch.from_numpy(px),
                                     torch.from_numpy(py))
    ref = jgs.sample_bilinear_pixels(jnp.asarray(img), jnp.asarray(px),
                                     jnp.asarray(py))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    pts = np.stack([px / 12, py / 10], -1).astype(np.float32)
    np.testing.assert_allclose(
        tgs.sample_at_points(torch.from_numpy(img),
                             torch.from_numpy(pts)).numpy(),
        np.asarray(jgs.sample_at_points(jnp.asarray(img), jnp.asarray(pts))),
        atol=1e-6)
