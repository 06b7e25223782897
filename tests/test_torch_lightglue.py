"""LightGlue in the PyTorch port vs the JAX reference (CPU, float32).

Same golden randomized full-width weights (9 layers, d = 256, 4 heads,
SuperPoint schema) on both sides. Tolerances: m0 equal and mscores within
1e-4 against the JAX forward cut to 2 layers, in the dense form and in the
fused form (the JAX Pallas kernel in interpret mode, the port's kernel-E
plain twin); against the reference's golden outputs at 9 layers, the JAX
package's own bound (agreement >= 0.97, mscores atol 2e-3).

The randomized weights leave every mscore near 0 (the golden fixture has
no match), so the log assignment scores, the full [K0, K1] matrix before
filtering, carry the comparison. They reach thousands, and f32 rounding
differences grow from layer to layer under random weights (to 8% of the
norm at 9 layers), so they are compared at 2 and 3 layers: Frobenius norm
of the difference within 1e-4 of the reference's, each entry within 1e-3
of the largest unmasked score, masked entries masked on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models import lightglue as jlg
from keypoint_bench_tpu_torch.models import lightglue as tlg
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
def golden():
    return np.load(f"{GOLDEN_DIR}/lightglue.npz")


@pytest.fixture(scope="module")
def params():
    return load_golden_params("lightglue")


@pytest.fixture(scope="module")
def jparams():
    return {k: jnp.asarray(v) for k, v in golden_npz("lightglue").items()}


def _inputs(golden, pad0=0, seed=0):
    """The golden keypoints and descriptors; pad0 masked junk rows on side
    0 and a few invalid rows on side 1."""
    rng = np.random.default_rng(seed)
    k0, d0 = golden["kpts0"][0], golden["desc0"][0]
    k1, d1 = golden["kpts1"][0], golden["desc1"][0]
    v0 = np.ones(len(k0) + pad0, bool)
    v0[len(k0):] = False
    k0 = np.concatenate([k0, rng.uniform(0, 511, (pad0, 2))]).astype(
        np.float32)
    d0 = np.concatenate([d0, rng.normal(0, 1, (pad0, 256))]).astype(
        np.float32)
    v1 = np.ones(len(k1), bool)
    if pad0:
        v1[::17] = False
    return k0, v0, d0, k1, v1, d1


def test_linears_are_transposed_to_out_in(params):
    """Every 2-D LightGlue tensor is a [in, out] linear in the JAX layout
    and [out, in] here, the 1-column ones included."""
    raw = golden_npz("lightglue")
    two_d = [k for k, v in raw.items() if v.ndim == 2]
    assert "posenc.Wr.weight" in two_d
    assert "log_assignment.0.matchability.weight" in two_d
    for k in two_d:
        assert tuple(params[k].shape) == raw[k].shape[::-1], k
        np.testing.assert_array_equal(params[k].numpy(), raw[k].T)
    assert tuple(params["posenc.Wr.weight"].shape) == (32, 2)
    assert tuple(params["log_assignment.8.matchability.weight"].shape) == \
        (1, 256)


def _jax_scores(p, k0, v0, d0, k1, v1, d1, n_layers, attn):
    """The JAX forward up to the assignment head, from its own blocks."""
    enc0 = jlg._posenc(p, jlg.normalize_keypoints_masked(k0, v0))
    enc1 = jlg._posenc(p, jlg.normalize_keypoints_masked(k1, v1))
    for i in range(n_layers):
        pre = f"transformers.{i}"
        d0 = jlg._self_block(p, f"{pre}.self_attn", d0, enc0, v0, 4, attn)
        d1 = jlg._self_block(p, f"{pre}.self_attn", d1, enc1, v1, 4, attn)
        d0, d1 = jlg._cross_block(p, f"{pre}.cross_attn", d0, d1, v0, v1, 4,
                                  attn)
    return jlg._assignment_scores(p, f"log_assignment.{n_layers - 1}", d0,
                                  d1, v0, v1)


def _close_scores(got, want):
    live = want > -1e8
    assert np.array_equal(got > -1e8, live)
    diff = np.abs(got - want)[live]
    assert diff.max() <= 1e-3 * np.abs(want[live]).max(), diff.max()
    assert np.linalg.norm(diff) <= 1e-4 * np.linalg.norm(want[live])


@pytest.mark.parametrize("attn,jattn", [("dense", "dense"),
                                        ("fused", "fused_interpret")])
@pytest.mark.parametrize("pad0", [0, 12])
def test_two_layers_match_jax(golden, params, jparams, attn, jattn, pad0):
    k0, v0, d0, k1, v1, d1 = _inputs(golden, pad0)
    m0_ref, ms_ref, ok_ref = jlg.lightglue_forward(
        jparams, *map(jnp.asarray, (k0, v0, d0, k1, v1, d1)), n_layers=2,
        attn=jattn)
    m0, ms, ok = tlg.lightglue_forward(
        params, *map(torch.from_numpy, (k0, v0, d0, k1, v1, d1)), n_layers=2,
        attn=attn)
    np.testing.assert_array_equal(m0.numpy(), np.asarray(m0_ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), atol=1e-4)
    sc_ref = _jax_scores(jparams, *map(jnp.asarray, (k0, v0, d0, k1, v1, d1)),
                         2, jattn)
    sc = tlg.lightglue_scores(params, *map(torch.from_numpy,
                                           (k0, v0, d0, k1, v1, d1)),
                              n_layers=2, attn=attn)
    _close_scores(sc.numpy(), np.asarray(sc_ref))


def test_nine_layers_match_golden(golden, params):
    k0, v0, d0, k1, v1, d1 = (golden["kpts0"][0], np.ones(64, bool),
                              golden["desc0"][0], golden["kpts1"][0],
                              np.ones(80, bool), golden["desc1"][0])
    m0, ms, _ = tlg.lightglue_forward(
        params, *map(torch.from_numpy, (k0, v0, d0, k1, v1, d1)))
    agree = (m0.numpy() == golden["matches0"][0]).mean()
    assert agree >= 0.97, agree
    np.testing.assert_allclose(ms.numpy(), golden["mscores0"][0], atol=2e-3)


def test_fused_form_equals_dense_and_batch_equals_per_pair(golden, params):
    """Two pairs of equal K in one call (one stacked self pass, one cross
    launch for both directions) equal the per-pair calls; the fused form
    equals the dense form."""
    a = _inputs(golden, 16, seed=1)
    b = _inputs(golden, 16, seed=2)
    b = (b[0][::-1].copy(), b[1][::-1].copy(), b[2][::-1].copy(), *b[3:])
    stack = [torch.from_numpy(np.stack([x, y])) for x, y in zip(a, b)]
    sc = tlg.lightglue_scores(params, *stack, n_layers=3, attn="fused")
    for i, case in enumerate((a, b)):
        args = [torch.from_numpy(x) for x in case]
        for attn in ("dense", "fused"):
            sc_i = tlg.lightglue_scores(params, *args, n_layers=3, attn=attn)
            _close_scores(sc[i].numpy(), sc_i.numpy())


def test_sample_descriptors_and_normalize_match_jax():
    rng = np.random.default_rng(3)
    dmap = rng.normal(0, 1, (2, 8, 10, 16)).astype(np.float32)
    kpts = rng.uniform(0, 64, (2, 20, 2)).astype(np.float32)
    valid = rng.random((2, 20)) > 0.2
    got = tlg.sample_descriptors_lg(torch.from_numpy(kpts),
                                    torch.from_numpy(dmap), 8)
    gotn = tlg.normalize_keypoints_masked(torch.from_numpy(kpts),
                                          torch.from_numpy(valid))
    for i in range(2):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(jlg.sample_descriptors_lg(
                jnp.asarray(kpts[i]), jnp.asarray(dmap[i]), 8)), atol=1e-6)
        np.testing.assert_allclose(
            gotn[i].numpy(), np.asarray(jlg.normalize_keypoints_masked(
                jnp.asarray(kpts[i]), jnp.asarray(valid[i]))), atol=1e-6)


def test_attn_forms_and_cuda_rule():
    assert tlg.resolve_attn("auto", torch.device("cpu")) == "dense"
    assert tlg.resolve_attn("fused", torch.device("cpu")) == "fused"
    assert tlg.resolve_attn("auto", torch.device("cuda")) == "fused"
    with pytest.raises(ValueError):
        tlg.resolve_attn("dense", torch.device("cuda"))
    with pytest.raises(ValueError):
        tlg.resolve_attn("flash", torch.device("cpu"))
