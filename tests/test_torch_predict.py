"""`predict_positions` in the PyTorch port (ops/predict.py) against the JAX
package's, on the CPU, on unit descriptor maps drawn from a seed.

Both packages compute the similarity and the expectation as float32
matrix products in their own summation orders. The predicted positions
agree within 1e-5 (7.8e-7 seen). The score is a sample of
exp((sim - max) / 0.01): the temperature multiplies the similarity's
rounding (a few ulps of 1, growing with sqrt(D)) by 100, so each side is
up to 1e-5 from the float64 result at D = 32 (9.5e-6 and 6.0e-6 seen
over seeds 0-4) and the two sides are held within 5e-5 of each other
(1.3e-5 seen), and each within 2e-5 of the port's float64 forward."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ops.predict import predict_positions as jax_predict
from keypoint_bench_tpu_torch.ops.predict import predict_positions
from test_predict_and_dense import torch_predict_positions


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _maps(shape, seed):
    rng = np.random.default_rng(seed)
    d0 = rng.random(shape).astype(np.float32)
    d1 = (d0 + 0.3 * rng.random(shape)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return d0, d1


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(8, 8, 16), (12, 16, 32)],
                         ids=["8x8x16", "12x16x32"])
def test_predict_positions_matches_jax(shape, seed):
    d0, d1 = _maps(shape, seed)
    got = predict_positions(torch.from_numpy(d0), torch.from_numpy(d1))
    ref = np.asarray(jax_predict(jnp.asarray(d0), jnp.asarray(d1)))
    f64 = predict_positions(torch.from_numpy(d0).double(),
                            torch.from_numpy(d1).double()).numpy()
    got = got.numpy()
    assert got.shape == ref.shape == (shape[0] * shape[1], 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[:, :2], ref[:, :2], atol=1e-5)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], atol=5e-5)
    for side in (got, ref):
        np.testing.assert_allclose(side[:, :2], f64[:, :2], atol=1e-5)
        np.testing.assert_allclose(side[:, 2], f64[:, 2], atol=2e-5)


def test_predict_positions_matches_reference_math():
    """tests/test_predict_and_dense.py's oracle of the reference's torch
    math (grid_sample + diagonal), at that test's tolerances."""
    d0, d1 = _maps((8, 8, 16), 0)
    got = predict_positions(torch.from_numpy(d0),
                            torch.from_numpy(d1)).numpy()
    ref = torch_predict_positions(d0, d1)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], atol=1e-4)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], atol=1e-3)


def test_predict_positions_rectangular_grid_order():
    """Row-major (y, x) source order and (x, y) outputs on a non-square
    map: identical descriptors with one sharp match per position predict
    each position's own cell centre."""
    h, w = 3, 5
    eye = np.eye(h * w, dtype=np.float32).reshape(h, w, h * w)
    got = predict_positions(torch.from_numpy(eye),
                            torch.from_numpy(eye)).numpy()
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    np.testing.assert_allclose(got[:, 0], xs.reshape(-1), atol=1e-6)
    np.testing.assert_allclose(got[:, 1], ys.reshape(-1), atol=1e-6)
