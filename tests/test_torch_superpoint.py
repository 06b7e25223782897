"""SuperPoint in the PyTorch port vs the JAX reference (CPU, float32).

Tolerance: atol 1e-4 against the JAX forward at HIGHEST conv precision and
against the golden torch-reference fixture (randomized full-width weights
under `param:` keys); both sides are exact f32 and differ only in
summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models import common as jc
from keypoint_bench_tpu.models.superpoint import superpoint
from keypoint_bench_tpu_torch.models import common as tc
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.weights import (load_golden_params, load_params,
                                              stage_golden_weights)
from keypoint_bench_tpu_torch.weights.io import GOLDEN_DIR, golden_npz


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def highest():
    jc.set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    jc.set_conv_precision(None)


@pytest.fixture(scope="module")
def model():
    return get_model("SuperPoint")(load_golden_params("SuperPoint")).eval()


@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 64, 96, 3)])
def test_forward_matches_jax(model, highest, shape):
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    params = {k: jnp.asarray(v) for k, v in golden_npz("SuperPoint").items()}
    s_ref, d_ref = superpoint(params, jnp.asarray(img))
    with torch.no_grad():
        s, d = model(torch.from_numpy(img))
    b, h, w, _ = shape
    assert s.shape == (b, h, w, 1) and d.shape == (b, h // 8, w // 8, 256)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-4)


def test_forward_matches_golden(model):
    g = np.load(f"{GOLDEN_DIR}/SuperPoint.npz")
    with torch.no_grad():
        s, d = model(torch.from_numpy(g["image"].transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(s[..., 0].numpy(), g["score"][:, 0], atol=1e-4)
    np.testing.assert_allclose(d.numpy(), g["desc"].transpose(0, 2, 3, 1),
                               atol=1e-4)


def test_uint8_input_is_scaled(model):
    """uint8 frames are divided by 255 (the JAX per-pair path's missing
    /255 is not copied)."""
    img = np.random.default_rng(1).integers(0, 256, (1, 32, 32, 3),
                                            dtype=np.uint8)
    with torch.no_grad():
        su, du = model(torch.from_numpy(img))
        sf, df = model(torch.from_numpy(img.astype(np.float32) / 255.0))
    assert torch.equal(su, sf) and torch.equal(du, df)


def test_depth_to_space_and_l2_normalize_match_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 5, 64)).astype(
        np.float32)
    got = tc.depth_to_space(torch.from_numpy(x).permute(0, 3, 1, 2), 8)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jc.depth_to_space(
                                      jnp.asarray(x), 8)))
    np.testing.assert_allclose(
        tc.l2_normalize(torch.from_numpy(x), dim=-1).numpy(),
        np.asarray(jc.l2_normalize(jnp.asarray(x), axis=-1)), atol=1e-7)
    with pytest.raises(ValueError):
        tc.depth_to_space(torch.zeros(1, 63, 2, 2), 8)


def test_staged_golden_weights_load_by_runner_names(tmp_path):
    d = stage_golden_weights(str(tmp_path / "w"))
    for name, stage in (("SuperPoint", "SuperPoint"),
                        ("lightglue", "lightglue_superpoint")):
        got = load_params(stage, d)
        want = load_golden_params(name)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
