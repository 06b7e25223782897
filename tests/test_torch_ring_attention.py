"""Ring attention on the CPU (mirrors tests/test_ring_attention.py): the
port's `ring_attention` over 1, 2 and 4 data ranks (threads over gloo)
against the JAX package's `ring_attention` on the conftest's 8-device
mesh and its `dense_attention`, and the port's own `dense_attention`, on
the JAX test's inputs: a padded tail, and a first chunk whose every key
is masked. Tolerance atol 1e-5, the JAX test's. A key set with no valid
key gives every query the uniform average of the values, in both
packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.parallel.mesh import make_mesh
from keypoint_bench_tpu.parallel.ring_attention import \
    dense_attention as jax_dense
from keypoint_bench_tpu.parallel.ring_attention import \
    ring_attention as jax_ring
from keypoint_bench_tpu_torch.parallel.mesh import Mesh, thread_ranks
from keypoint_bench_tpu_torch.parallel.ring_attention import (
    dense_attention, gather_rows, ring_attention)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name):
    """The inputs of tests/test_ring_attention.py's two tests, and an
    all-invalid key set."""
    seed, h, nq, nk, d = {"padded_tail": (0, 4, 64, 128, 32),
                          "masked_shard": (1, 2, 16, 64, 16),
                          "all_invalid": (2, 2, 16, 64, 16)}[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (h, n, d)).astype(np.float32)
               for n in (nq, nk, nk))
    valid = np.ones(nk, bool)
    if name == "padded_tail":
        valid[120:] = False
    elif name == "masked_shard":
        valid[: nk // 8] = False    # the first of 8 chunks, all masked
    else:
        valid[:] = False
    return q, k, v, valid


def _ring(arrays, world):
    q, k, v, valid = (torch.from_numpy(a) for a in arrays)
    outs = thread_ranks(
        lambda mesh: gather_rows(mesh, ring_attention(mesh, q, k, v, valid),
                                 1), world, device="cpu")
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0].numpy()


@pytest.fixture(scope="module")
def jax_outs():
    """The JAX ring and dense outputs of each case (mesh of 8)."""
    mesh = make_mesh(n_data=8)
    out = {}
    for name in ("padded_tail", "masked_shard", "all_invalid"):
        args = [jnp.asarray(a) for a in _case(name)]
        out[name] = (np.asarray(jax_ring(mesh, *args)),
                     np.asarray(jax_dense(*args)))
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", ["padded_tail", "masked_shard"])
def test_ring_equals_jax_and_dense(jax_outs, name, world):
    arrays = _case(name)
    got = _ring(arrays, world)
    ring_j, dense_j = jax_outs[name]
    np.testing.assert_allclose(got, ring_j, atol=1e-5)
    np.testing.assert_allclose(got, dense_j, atol=1e-5)
    dense_t = dense_attention(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(got, dense_t.numpy(), atol=1e-5)


def test_all_invalid_keys_give_uniform_rows(jax_outs):
    q, k, v, valid = _case("all_invalid")
    got = _ring((q, k, v, valid), 4)
    uniform = np.broadcast_to(v.mean(1, keepdims=True), got.shape)
    np.testing.assert_allclose(got, uniform, atol=1e-5)
    for j in jax_outs["all_invalid"]:
        np.testing.assert_allclose(got, j, atol=1e-5)


def test_ring_rejects_a_world_that_does_not_divide():
    q, k, v, valid = (torch.from_numpy(a) for a in _case("masked_shard"))
    with pytest.raises(ValueError, match="do not divide"):
        ring_attention(Mesh(3, 1, 0, torch.device("cpu")), q, k, v, valid)
