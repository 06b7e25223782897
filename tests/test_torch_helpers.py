"""The port's small public helpers against the JAX package's (CPU):
`list_models`, `rotmat_to_quat` on its four branches, `relative_pose`,
and `grid_sample_align_corners` (through which `sample_at_points` goes)
within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.geometry import se3 as jse3
from keypoint_bench_tpu.models import list_models as jax_list_models
from keypoint_bench_tpu.ops import grid_sample as jgs
from keypoint_bench_tpu_torch.geometry import se3 as tse3
from keypoint_bench_tpu_torch.models import list_models
from keypoint_bench_tpu_torch.ops import grid_sample as tgs


def test_list_models_equals_jax():
    names = list_models()
    assert names == jax_list_models()
    assert len(names) == 17
    assert {"Alike_s2d", "LETNet_s2d", "GoodPoint_s2d"} <= set(names)


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = jse3.skew(axis)
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


# one rotation for each branch: trace > 0, then R00, R11 or R22 the largest
# diagonal entry of a rotation by nearly pi
BRANCHES = {"trace": _rot([0.2, -0.5, 1.0], 0.7),
            "x": _rot([1.0, 0.2, -0.1], 3.0),
            "y": _rot([0.1, 1.0, 0.3], 3.0),
            "z": _rot([-0.2, 0.1, 1.0], 3.0)}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_rotmat_to_quat_equals_jax(branch):
    R = BRANCHES[branch]
    diag = np.diag(R)
    assert (np.trace(R) > 0) == (branch == "trace")
    if branch != "trace":
        assert "xyz"[int(np.argmax(diag))] == branch
    got = tse3.rotmat_to_quat(R)
    np.testing.assert_allclose(got, jse3.rotmat_to_quat(R), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tse3.quat_to_rotmat(got), R, atol=1e-6)


def test_relative_pose_equals_jax():
    rng = np.random.default_rng(0)
    T0 = tse3.make_T(_rot(rng.normal(size=3), 0.4), rng.normal(size=3))
    T1 = tse3.make_T(_rot(rng.normal(size=3), 1.1), rng.normal(size=3))
    got = tse3.relative_pose(T0, T1)
    np.testing.assert_allclose(got, jse3.relative_pose(T0, T1), atol=1e-6,
                               rtol=0)
    p = np.array([0.3, -0.2, 2.0, 1.0])
    np.testing.assert_allclose(got @ p, np.linalg.inv(T1) @ (T0 @ p),
                               atol=1e-9)


def test_grid_sample_align_corners_equals_jax():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(13, 17, 5)).astype(np.float32)
    # inside, on the corners and edges, and out of bounds
    pts = np.concatenate([rng.uniform(-0.1, 1.1, (40, 2)),
                          [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 1.0]]]
                         ).astype(np.float32)
    want = np.asarray(jgs.grid_sample_align_corners(jnp.asarray(img),
                                                    jnp.asarray(pts)))
    got = tgs.grid_sample_align_corners(torch.from_numpy(img),
                                        torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    kpts = np.concatenate([pts, rng.random((len(pts), 1), np.float32)], 1)
    np.testing.assert_allclose(
        tgs.sample_at_points(torch.from_numpy(img),
                             torch.from_numpy(kpts)).numpy(),
        np.asarray(jgs.sample_at_points(jnp.asarray(img),
                                        jnp.asarray(kpts))),
        atol=1e-6, rtol=0)
    # leading batch dimensions: each image at its own points
    imgs = np.stack([img, img[::-1].copy()])
    batch = tgs.grid_sample_align_corners(
        torch.from_numpy(imgs), torch.from_numpy(np.stack([pts, pts])))
    np.testing.assert_allclose(batch[0].numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        batch[1].numpy(), np.asarray(jgs.grid_sample_align_corners(
            jnp.asarray(imgs[1]), jnp.asarray(pts))), atol=1e-6, rtol=0)
