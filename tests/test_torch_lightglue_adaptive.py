"""Adaptive LightGlue (depth early exit and width pruning) in the PyTorch
port vs the JAX reference (CPU, float32).

The golden randomized full-width weights (9 layers, d = 256, 4 heads) on
both sides. Inputs are the golden adaptive fixture's keypoints (64 and
80) and descriptors, permuted, perturbed and partly masked from a numpy
seed, or seeded random ones (which no layer prunes). The number of
layers run, the matches and the match mask must be equal. mscores are
held within 0.08, the JAX package's own bound against the reference
(tests/test_lightglue_adaptive.py): under the randomized weights the
log scores reach thousands, and each package's float32 mscores part
from the float64 forward by up to 0.051 on these inputs once layers
prune (measured), so a 1e-5 bound would hold rounding, not semantics.
Where no layer prunes they agree within 1e-9.

The "fused" form (kernel E's plain twin on the CPU) must give the dense
form's result and hand every attention the masks of the current layer:
the per-head masks are rebuilt after each layer that prunes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.models.lightglue_adaptive import \
    lightglue_forward_adaptive as jax_adaptive
from keypoint_bench_tpu_torch.models import lightglue as tlg
from keypoint_bench_tpu_torch.models.lightglue_adaptive import (
    conf_thresholds, lightglue_forward_adaptive)
from keypoint_bench_tpu_torch.weights import load_golden_params
from keypoint_bench_tpu_torch.weights.io import GOLDEN_DIR, golden_npz

MSCORE_TOL = 0.08
# name: (seed, descriptor noise, invalid rows a side, K1, options)
CASES = {
    "permuted": (0, 0.0, 0, 80, {}),
    "noisy": (1, 0.02, 0, 80, {}),
    "masked": (2, 0.02, 2, 80, {}),
    "random": (3, None, 6, 80, {}),
    "same-k": (1, 0.02, 1, 64, {}),
    "width-0": (0, 0.02, 2, 80, {"width_confidence": 0.0}),
    "emptied": (1, 0.02, 0, 80, {"width_confidence": 0.0,
                                 "depth_confidence": 1.1}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Nine layers of small matrices a forward, which torch's intra-op
    threads slow down where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return np.load(f"{GOLDEN_DIR}/lightglue_adaptive.npz")


@pytest.fixture(scope="module")
def params():
    return load_golden_params("lightglue")


@pytest.fixture(scope="module")
def jparams():
    return {k: jnp.asarray(v) for k, v in golden_npz("lightglue").items()}


def _inputs(golden, name):
    """(kpts0, valid0, desc0, kpts1, valid1, desc1) as numpy."""
    seed, noise, n_inv, k1_n, _ = CASES[name]
    rng = np.random.default_rng(seed)
    k0, d0 = golden["kpts0"][0], golden["desc0"][0]
    k1, d1 = golden["kpts1"][0][:k1_n], golden["desc1"][0][:k1_n]
    if noise is None:
        k0, k1 = (rng.uniform(0, 511, k.shape) for k in (k0, k1))
        d0, d1 = (rng.normal(size=d.shape) for d in (d0, d1))
        d0, d1 = (d / np.linalg.norm(d, axis=1, keepdims=True)
                  for d in (d0, d1))
    else:
        p0, p1 = rng.permutation(len(k0)), rng.permutation(len(k1))
        k0 = k0[p0] + rng.normal(0, 50 * noise, k0.shape)
        k1 = k1[p1] + rng.normal(0, 50 * noise, k1.shape)
        d0 = d0[p0] + rng.normal(0, noise, d0.shape)
        d1 = d1[p1] + rng.normal(0, noise, d1.shape)
    v0, v1 = np.ones(len(k0), bool), np.ones(len(k1), bool)
    v0[rng.choice(len(k0), n_inv, replace=False)] = False
    v1[rng.choice(len(k1), n_inv, replace=False)] = False
    f32 = [np.asarray(x, np.float32) for x in (k0, d0, k1, d1)]
    return f32[0], v0, f32[1], f32[2], v1, f32[3]


@pytest.fixture(scope="module")
def jax_runs(golden, jparams):
    """The JAX forward of every case, run once for the module."""
    out = {}
    for name, case in CASES.items():
        res = jax_adaptive(jparams, *map(jnp.asarray, _inputs(golden, name)),
                           **case[4])
        out[name] = [np.asarray(x) for x in res]
    return out


def _port(params, args, **kw):
    m0, ms, ok, i_fin = lightglue_forward_adaptive(
        params, *map(torch.from_numpy, args), **kw)
    return m0.numpy(), ms.numpy(), ok.numpy(), i_fin


def test_thresholds_match_the_reference_formula():
    th = conf_thresholds(9)
    assert len(th) == 9 and th[0] == np.float32(0.9)
    want = np.clip(0.8 + 0.1 * np.exp(-4.0 * np.arange(9) / 9), 0, 1)
    np.testing.assert_array_equal(th, want.astype(np.float32))


def test_matches_reference_golden(golden, params):
    """The reference's default-mode outputs: the stop layer and matches0
    exact, mscores within 0.08 (tests/test_lightglue_adaptive.py)."""
    k0, k1 = golden["kpts0"][0], golden["kpts1"][0]
    stats = {}
    m0, ms, _, i_fin = lightglue_forward_adaptive(
        params, torch.from_numpy(k0), torch.ones(len(k0), dtype=torch.bool),
        torch.from_numpy(golden["desc0"][0]), torch.from_numpy(k1),
        torch.ones(len(k1), dtype=torch.bool),
        torch.from_numpy(golden["desc1"][0]), stats=stats)
    assert i_fin == int(golden["stop"])
    np.testing.assert_array_equal(m0.numpy(), golden["matches0"][0])
    np.testing.assert_allclose(ms.numpy(), golden["mscores0"][0],
                               atol=MSCORE_TOL)
    # the fixture prunes from the first layer on, and reads stop once a
    # layer until it stops
    keep = [(int(a), int(b)) for a, b in stats["keep"]]
    assert len(keep) == i_fin and keep[0] < (len(k0), len(k1))
    assert stats["syncs"] == i_fin and len(stats["margin"]) == i_fin


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(golden, params, jax_runs, name):
    args = _inputs(golden, name)
    m0, ms, ok, i_fin = _port(params, args, **CASES[name][4])
    jm0, jms, jok, j_fin = jax_runs[name]
    assert i_fin == int(j_fin)
    np.testing.assert_array_equal(m0, jm0)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_allclose(ms, jms, atol=MSCORE_TOL)


def test_pruning_paths_are_exercised(golden, params):
    """The cases reach what they are named for: early stops, pruning, a
    side emptied while the other keeps tokens, and no pruning at all."""
    keeps = {}
    for name, case in CASES.items():
        stats = {}
        _, _, _, i_fin = _port(params, _inputs(golden, name),
                               stats=stats, **case[4])
        keeps[name] = (i_fin, [(int(a), int(b)) for a, b in stats["keep"]])
    assert keeps["random"][0] == 8
    assert set(keeps["random"][1]) == {(58, 74)}
    assert all(keeps[n][0] < 9 for n in ("permuted", "noisy", "masked"))
    assert keeps["emptied"][0] == 9 and keeps["emptied"][1][-1] == (0, 0)
    assert any(a == 0 < b for a, b in keeps["emptied"][1])
    # width_confidence 0 prunes every confident token, so it keeps fewer
    # than the default on the same inputs from the first layer on
    stats = {}
    _port(params, _inputs(golden, "width-0"), stats=stats)
    default = [(int(a), int(b)) for a, b in stats["keep"]]
    assert all(w < d for w, d in zip(keeps["width-0"][1][0], default[0]))


def test_full_depth_equals_fixed_depth_forward(golden, params):
    """Confidences that can never trigger: every layer runs and nothing
    is pruned, so the adaptive forward is the fixed-depth one."""
    for name in ("masked", "same-k"):
        args = [torch.from_numpy(a) for a in _inputs(golden, name)]
        m0, ms, ok, i_fin = lightglue_forward_adaptive(
            params, *args, depth_confidence=1.1, width_confidence=1.1)
        fm0, fms, fok = tlg.lightglue_forward(params, *args)
        assert i_fin == 9
        assert torch.equal(m0, fm0) and torch.equal(ok, fok)
        torch.testing.assert_close(ms, fms, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["masked", "same-k", "emptied"])
def test_fused_form_rebuilds_masks_after_pruning(golden, params, monkeypatch,
                                                 name):
    """The fused form through kernel E's plain twin equals the dense form
    (layers run, matches and keep counts; mscores within the JAX bound,
    the two forms summing in other orders), and the masks handed to
    every attention call of a layer hold as many valid keys as the layer
    before left valid."""
    args = [torch.from_numpy(a) for a in _inputs(golden, name)]
    opts = CASES[name][4]
    dense, stats = {}, {}
    want = lightglue_forward_adaptive(params, *args, attn="dense",
                                      stats=dense, **opts)
    calls = []
    real = tlg.masked_attention

    def record(q, k, v, kv_valid, scale=None):
        calls.append(kv_valid.reshape(-1, kv_valid.shape[-1]).sum(-1))
        return real(q, k, v, kv_valid, scale)

    monkeypatch.setattr(tlg, "masked_attention", record)
    got = lightglue_forward_adaptive(params, *args, attn="fused",
                                     stats=stats, **opts)
    assert got[3] == want[3]
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], atol=MSCORE_TOL, rtol=0)
    keep = [(int(a), int(b)) for a, b in stats["keep"]]
    assert keep == [(int(a), int(b)) for a, b in dense["keep"]]
    same = args[0].shape == args[3].shape
    per_layer = 2 if same else 4
    assert len(calls) == per_layer * got[3]
    before = [(int(args[1].sum()), int(args[4].sum()))] + keep
    for i in range(got[3]):
        n0, n1 = before[i]
        layer = calls[per_layer * i: per_layer * (i + 1)]
        if same:
            # self: [side 0, side 1] per head; cross: [side 1, side 0]
            assert layer[0].unflatten(0, (2, -1)).tolist() == \
                [[n0] * 4, [n1] * 4]
            assert layer[1].unflatten(0, (2, -1)).tolist() == \
                [[n1] * 4, [n0] * 4]
        else:
            assert [c.tolist() for c in layer] == \
                [[n0] * 4, [n1] * 4, [n1] * 4, [n0] * 4]
