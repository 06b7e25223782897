"""Head-sharded (tensor-parallel) LightGlue on the CPU: the port's
`lightglue_forward_tp` over 2 and 4 model ranks (threads over gloo)
against its dense forward and the JAX package's `lightglue_forward_tp` on
the conftest's mesh (mirrors tests/test_lightglue_tp.py), on the golden
LightGlue weights and keypoints.

Tolerances: tests/test_lightglue_tp.py's own at 9 layers (matches agree
on more than 99% of the rows, mscores within 1e-3). The randomized
weights leave every mscore near 0, so the log assignment scores carry
the comparison, at 2 layers as tests/test_torch_lightglue.py compares
them: the Frobenius norm of the difference within 1e-4 of the dense
scores'. The sharded sums (each rank's heads' partial products, then the
all_reduce) differ from the dense projection in float order only. Every
rank returns the same result; the fused attention form (kernel E's plain
twin on the CPU) gives the dense form's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from keypoint_bench_tpu.models.lightglue import \
    lightglue_forward as jax_forward
from keypoint_bench_tpu.parallel.lightglue_tp import \
    lightglue_forward_tp as jax_forward_tp
from keypoint_bench_tpu.parallel.lightglue_tp import \
    shard_lightglue_params as jax_shard
from keypoint_bench_tpu.parallel.mesh import make_mesh
from keypoint_bench_tpu_torch.models.lightglue import (lightglue_forward,
                                                       lightglue_scores)
from keypoint_bench_tpu_torch.parallel.lightglue_tp import (
    lightglue_forward_tp, shard_lightglue_params)
from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
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
    v0, v1 = np.ones(len(k0), bool), np.ones(len(k1), bool)
    return k0, v0, d0, k1, v1, d1


@pytest.fixture(scope="module")
def params():
    return load_golden_params("lightglue")


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_dense(inputs):
    """The JAX package's dense forward on the same weights and inputs."""
    jp = {k: jnp.asarray(v) for k, v in golden_npz("lightglue").items()}
    return [np.asarray(x) for x in jax_forward(
        jp, *[jnp.asarray(a) for a in inputs])]


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_matches_dense_and_jax(inputs, params, jax_dense, n_model):
    """Against the port's dense forward and the JAX package's (its TP
    forward equals its dense one: tests/test_lightglue_tp.py)."""
    args = _t(inputs)
    m0_d, ms_d, _ = lightglue_forward(params, *args)
    sp = shard_lightglue_params(params, n_model)
    outs = thread_ranks(lambda mesh: lightglue_forward_tp(mesh, sp, *args),
                        1, n_model, device="cpu")
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    m0_t, ms_t, ok_t = outs[0]
    assert (m0_t == m0_d).float().mean() > 0.99
    np.testing.assert_allclose(ms_t.numpy(), ms_d.numpy(), atol=1e-3)

    m0_j, ms_j, _ = jax_dense
    assert (m0_t.numpy() == m0_j).mean() > 0.99
    np.testing.assert_allclose(ms_t.numpy(), ms_j, atol=1e-3)


def test_tp_matches_jax_tp(inputs, params):
    """The port's and the JAX package's head-sharded forwards over 2
    model ranks."""
    jp = {k: jnp.asarray(v) for k, v in golden_npz("lightglue").items()}
    mesh = make_mesh(n_data=len(jax.devices()) // 2, n_model=2)
    m0_j, ms_j, _ = jax_forward_tp(mesh, jax_shard(jp, 2),
                                   *[jnp.asarray(a) for a in inputs])
    sp = shard_lightglue_params(params, 2)
    m0_t, ms_t, _ = thread_ranks(
        lambda m: lightglue_forward_tp(m, sp, *_t(inputs)), 1, 2,
        device="cpu")[0]
    assert (m0_t.numpy() == np.asarray(m0_j)).mean() > 0.99
    np.testing.assert_allclose(ms_t.numpy(), np.asarray(ms_j), atol=1e-3)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("attn", ["dense", "fused"])
def test_tp_scores_at_two_layers(inputs, params, n_model, attn):
    """The log assignment scores of a 2-layer forward: each rank's heads
    (kernel E's plain twin in the fused form), the output projections
    summed over the ranks."""
    args = _t(inputs)
    want = lightglue_scores(params, *args, n_layers=2, attn="dense")
    sp = shard_lightglue_params(params, n_model)

    def fn(mesh):
        r = mesh.model_rank
        p = {k: (v[r] if v.dim() > params[k].dim() else v)
             for k, v in sp.items()}

        def out(p, name, x):
            part = F.linear(x, p[f"{name}.weight"])
            return mesh.all_reduce(part, "model") + p[f"{name}.bias"]

        return lightglue_scores(p, *args, n_layers=2,
                                num_heads=4 // n_model, attn=attn, out=out)

    got = thread_ranks(fn, 1, n_model, device="cpu")[0]
    assert float((got - want).norm()) <= 1e-4 * float(want.norm())


def test_shard_layout(params):
    """A row block of Wqkv / to_qk / to_v and a column block of out_proj /
    to_out is a head block; the shards put back together are the
    weights; every other parameter is left as it is."""
    sp = shard_lightglue_params(params, 2)
    pre = "transformers.0"
    w = params[f"{pre}.self_attn.Wqkv.weight"]
    assert torch.equal(sp[f"{pre}.self_attn.Wqkv.weight"].reshape(w.shape), w)
    wo = params[f"{pre}.cross_attn.to_out.weight"]
    assert torch.equal(torch.cat(list(sp[f"{pre}.cross_attn.to_out.weight"]),
                                 dim=1), wo)
    assert torch.equal(sp[f"{pre}.cross_attn.to_out.bias"],
                       params[f"{pre}.cross_attn.to_out.bias"])
    with pytest.raises(ValueError, match="do not split"):
        shard_lightglue_params(params, 3)
