"""Sequence-parallel (ring-attention) LightGlue on the CPU (mirrors
tests/test_lightglue_sp.py): the port's `lightglue_forward_sp` over 2 and
4 data ranks (threads over gloo) against the JAX package's
`lightglue_forward_sp` on the conftest's 8-device mesh (one call, shared
by the module) and against the port's dense `lightglue_forward`, on the
golden LightGlue weights and keypoints (64 and 80 keypoints, 9 layers).
Tolerances: the JAX test's, matches equal and mscores within 2e-3. The
randomized weights leave every mscore near 0, so the log assignment
scores of a 2-layer forward carry a closer comparison, as
tests/test_torch_parallel_tp.py makes it: the Frobenius norm of the
difference within 1e-4 of the dense scores'.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.parallel.lightglue_sp import \
    lightglue_forward_sp as jax_forward_sp
from keypoint_bench_tpu.parallel.mesh import make_mesh
from keypoint_bench_tpu_torch.models.lightglue import (lightglue_forward,
                                                       lightglue_scores)
from keypoint_bench_tpu_torch.parallel.lightglue_sp import (
    lightglue_forward_sp, lightglue_scores_sp)
from keypoint_bench_tpu_torch.parallel.mesh import Mesh, thread_ranks
from keypoint_bench_tpu_torch.weights import load_golden_params
from keypoint_bench_tpu_torch.weights.io import GOLDEN_DIR, golden_npz


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    g = np.load(f"{GOLDEN_DIR}/lightglue.npz")
    k0, d0, k1, d1 = (g[k][0] for k in ("kpts0", "desc0", "kpts1", "desc1"))
    return k0, np.ones(len(k0), bool), d0, k1, np.ones(len(k1), bool), d1


@pytest.fixture(scope="module")
def params():
    return load_golden_params("lightglue")


@pytest.fixture(scope="module")
def jax_sp(inputs):
    """The JAX package's SP forward over its 8-device mesh, once."""
    jp = {k: jnp.asarray(v) for k, v in golden_npz("lightglue").items()}
    out = jax_forward_sp(make_mesh(n_data=8), jp,
                         *[jnp.asarray(a) for a in inputs])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("world", [2, 4])
def test_sp_matches_dense_and_jax(inputs, params, jax_sp, world):
    args = [torch.from_numpy(a) for a in inputs]
    m0_d, ms_d, ok_d = lightglue_forward(params, *args)
    outs = thread_ranks(
        lambda mesh: lightglue_forward_sp(mesh, params, *args), world,
        device="cpu")
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    m0, ms, ok = outs[0]
    assert torch.equal(m0, m0_d) and torch.equal(ok, ok_d)
    np.testing.assert_allclose(ms.numpy(), ms_d.numpy(), atol=2e-3)
    m0_j, ms_j, ok_j = jax_sp
    np.testing.assert_array_equal(m0.numpy(), m0_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    np.testing.assert_allclose(ms.numpy(), ms_j, atol=2e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_sp_scores_at_two_layers(inputs, params, world):
    args = [torch.from_numpy(a) for a in inputs]
    want = lightglue_scores(params, *args, n_layers=2, attn="dense")
    got = thread_ranks(
        lambda mesh: lightglue_scores_sp(mesh, params, *args, n_layers=2),
        world, device="cpu")[0]
    assert float((got - want).norm()) <= 1e-4 * float(want.norm())


def test_sp_rejects_a_world_that_does_not_divide_k(inputs, params):
    args = [torch.from_numpy(a) for a in inputs]
    with pytest.raises(ValueError, match="do not divide 64"):
        lightglue_forward_sp(Mesh(3, 1, 0, torch.device("cpu")), params,
                             *args)
