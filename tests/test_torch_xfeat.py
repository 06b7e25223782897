"""XFeat and its common helpers in the PyTorch port vs the JAX reference
(CPU, float32).

Tolerances: the helpers within 1e-6 (same operations, other summation
order); the forward within 1e-5 of the JAX `xfeat` at HIGHEST conv
precision on a 128^2 image, and within 5e-4 of the golden torch-reference
fixture (randomized full-width weights), as tests/test_models.py holds the
JAX package. The pixel unshuffle XFeat's keypoint head reads equals the
JAX `_unfold8` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from keypoint_bench_tpu.models import common as jc
from keypoint_bench_tpu.models.xfeat import _unfold8, xfeat
from keypoint_bench_tpu_torch.models import common as tc
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.weights import (lightglue_input_proj_params,
                                              load_golden_params, load_params,
                                              stage_golden_weights)
from keypoint_bench_tpu_torch.weights.io import (GOLDEN_DIR,
                                                 GOLDEN_STAGE_NAMES,
                                                 golden_npz)


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
    return get_model("XFeat")(load_golden_params("XFeat")).eval()


def _nhwc(seed, shape=(2, 12, 20, 5)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(fn):
    """An NCHW port helper applied to an NHWC numpy array, back to NHWC."""
    return lambda x, *a: fn(torch.from_numpy(x).permute(0, 3, 1, 2),
                            *a).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,port,ref,args", [
    ("instance_norm", _nchw(tc.instance_norm), jc.instance_norm, ()),
    ("avg_pool", _nchw(tc.avg_pool), jc.avg_pool, (4,)),
    ("resize_half_up", _nchw(tc.resize_bilinear_half_pixel),
     jc.resize_bilinear_half_pixel, (24, 40)),
    ("resize_half_odd", _nchw(tc.resize_bilinear_half_pixel),
     jc.resize_bilinear_half_pixel, (7, 33)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_common_helpers_match_jax(name, port, ref, args):
    x = _nhwc(1) * 3 + 1
    np.testing.assert_allclose(port(x, *args),
                               np.asarray(ref(jnp.asarray(x), *args)),
                               atol=1e-6, err_msg=name)


def test_unfold8_is_pixel_unshuffle():
    x = np.random.default_rng(2).random((2, 64, 96, 1)).astype(np.float32)
    got = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 8)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(_unfold8(jnp.asarray(x))))


def test_forward_matches_jax(model, highest):
    img = np.random.default_rng(0).random((2, 128, 128, 3)).astype(
        np.float32)
    params = {k: jnp.asarray(v) for k, v in golden_npz("XFeat").items()}
    s_ref, d_ref = xfeat(params, jnp.asarray(img))
    with torch.no_grad():
        s, d = model(torch.from_numpy(img))
    assert s.shape == (2, 128, 128, 1) and d.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-5)


def test_forward_matches_golden(model):
    g = np.load(f"{GOLDEN_DIR}/XFeat.npz")
    with torch.no_grad():
        s, d = model(torch.from_numpy(g["image"].transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(s[..., 0].numpy(), g["score"][:, 0],
                               atol=5e-4)
    np.testing.assert_allclose(d.numpy(), g["desc"].transpose(0, 2, 3, 1),
                               atol=5e-4)


def test_staged_xfeat_loads_by_runner_name(tmp_path):
    assert GOLDEN_STAGE_NAMES["XFeat"] == "XFeat"
    d = stage_golden_weights(str(tmp_path / "w"))
    got, want = load_params("XFeat", d), load_golden_params("XFeat")
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_lightglue_input_proj_is_bench_projection():
    """bench.py:247-256: rng(7).normal(0, 0.1, (64, dim)) in the JAX [in,
    out] layout, zero bias; the port holds torch's [out, in]."""
    p = lightglue_input_proj_params()
    dim = p["transformers.0.self_attn.Wqkv.weight"].shape[1]
    want = np.random.default_rng(7).normal(0, 0.1, (64, dim))
    np.testing.assert_array_equal(p["input_proj.weight"].numpy(),
                                  want.astype(np.float32).T)
    assert p["input_proj.weight"].shape == (dim, 64)
    assert not p["input_proj.bias"].any()
    base = load_golden_params("lightglue")
    assert sorted(p) == sorted([*base, "input_proj.weight",
                                "input_proj.bias"])
