"""ALIKE-t in the PyTorch port vs the JAX reference (CPU, float32).

Tolerance: atol 1e-4 against the JAX forward at HIGHEST conv precision
(both sides are exact f32; they differ only in summation order), and the
JAX package's own 2e-4 against the golden torch-reference fixture.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models.alike import alike
from keypoint_bench_tpu.models.alike_s2d import (alike_s2d_feats_cm,
                                                 transform_params_s2d)
from keypoint_bench_tpu.models.common import set_conv_precision
from keypoint_bench_tpu.weights import load_params as jax_load_params
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.models.alike import Alike
from keypoint_bench_tpu_torch.weights import (load_npz, load_params,
                                              params_from_jax)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "Alike.npz")


@pytest.fixture
def highest():
    set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    set_conv_precision(None)


@pytest.fixture(scope="module")
def model():
    return Alike(params_from_jax(load_npz("Alike"))).eval()


def _image(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 64, 96, 3), (1, 128, 128, 3)])
def test_forward_matches_jax(model, highest, shape):
    img = _image(shape, 0)
    s_ref, d_ref = alike(jax_load_params("Alike"), jnp.asarray(img))
    with torch.no_grad():
        s, d = model(torch.from_numpy(img))
    assert s.shape == (*shape[:3], 1) and d.shape == (*shape[:3], 64)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-4)


def test_forward_matches_golden(model):
    g = np.load(GOLDEN)
    img = torch.from_numpy(g["image"].transpose(0, 2, 3, 1).copy())
    with torch.no_grad():
        s, d = model(img)
    np.testing.assert_allclose(s[..., 0].numpy(), g["score"][:, 0],
                               atol=2e-4)
    np.testing.assert_allclose(d.numpy(), g["desc"].transpose(0, 2, 3, 1),
                               atol=2e-4)


def test_feats_matches_jax_feats_cm(model, highest):
    img = _image((2, 128, 96, 3), 1)
    s_ref, f_ref = alike_s2d_feats_cm(
        transform_params_s2d(jax_load_params("Alike")), jnp.asarray(img))
    with torch.no_grad():
        s, feats = model.feats(torch.from_numpy(img))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    assert [tuple(f.shape) for f in feats] == [
        (2, 16, 128, 96), (2, 16, 64, 48), (2, 16, 16, 12), (2, 16, 4, 3)]
    for i, (a, b) in enumerate(zip(feats, f_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=f"branch {i}")


def test_feats_score_matches_dense_score(model):
    """feats' per-branch score projection == the dense head's score."""
    img = torch.from_numpy(_image((1, 64, 64, 3), 2))
    with torch.no_grad():
        s_dense, _ = model(img)
        s_feats, _ = model.feats(img)
    np.testing.assert_allclose(s_feats.numpy(), s_dense.numpy(), atol=1e-5)


def test_uint8_images_are_normalized(model):
    img8 = (np.random.default_rng(3).random((1, 64, 64, 3)) * 255).astype(
        np.uint8)
    with torch.no_grad():
        s8, d8 = model(torch.from_numpy(img8))
        sf, df = model(torch.from_numpy(img8.astype(np.float32) / 255.0))
    np.testing.assert_array_equal(s8.numpy(), sf.numpy())
    np.testing.assert_array_equal(d8.numpy(), df.numpy())


@pytest.mark.parametrize("name", ["Alike", "Alike_s2d"])
def test_registry_and_loader(name):
    assert get_model(name) is Alike
    params = load_params(name)
    ref = load_npz("Alike")
    assert set(params) == set(ref)
    w = ref["block2.conv1.weight"]                         # HWIO
    np.testing.assert_array_equal(params["block2.conv1.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(params["block2.bn1.running_var"].numpy(),
                                  ref["block2.bn1.running_var"])


def test_params_from_jax_layouts():
    rng = np.random.default_rng(4)
    conv = rng.random((3, 5, 2, 7)).astype(np.float32)
    lin = rng.random((4, 6)).astype(np.float32)
    vec = rng.random(7).astype(np.float32)
    out = params_from_jax({"c": conv, "l": lin, "v": vec})
    assert out["c"].shape == (7, 2, 3, 5) and out["c"].is_contiguous()
    np.testing.assert_array_equal(out["c"][6, 1, 2, 4].item(),
                                  conv[2, 4, 1, 6])
    np.testing.assert_array_equal(out["l"].numpy(), lin.T)
    np.testing.assert_array_equal(out["v"].numpy(), vec)
    assert all(t.dtype == torch.float32 for t in out.values())
