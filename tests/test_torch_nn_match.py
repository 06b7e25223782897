"""Kernel D's plain twin (ops/matching.py `nn_dists`, `mutual_nn_fused`)
vs the JAX Pallas kernel in interpret mode and the dense JAX matcher (CPU).

Descriptors are integers plus a common offset, so every distance between
valid rows is exact in f32 on both sides and ties are real ties (the
first index must win). Each row of side 1 has a planted near copy on side
0, so even rows carrying the 1e8 penalty (where f32 spacing is 8 to 16)
have a nearest neighbour far ahead of the second. Indices must be equal;
d within 1e-5 relative to the larger of |d| and |a|^2 + |b|^2.

The TPU kernel zero-pads rows to its tile, and those phantom rows take
part in its minima; the port's kernel and twin do not pad. The offset
keeps every phantom (distance |a|^2) behind the real neighbours, so the
two agree at ragged shapes; the last test shows where they part.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ops import matching as jm
from keypoint_bench_tpu.ops import pallas_match as jpm
from keypoint_bench_tpu_torch.ops import _build, cuda_match
from keypoint_bench_tpu_torch.ops import matching as tm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(m, n, d, seed, invalid=True):
    rng = np.random.default_rng(seed)
    a = (10 + rng.integers(-3, 4, (m, d))).astype(np.float32)
    b = (10 + rng.integers(-3, 4, (n, d))).astype(np.float32)
    perm = rng.permutation(m)[:n]
    b[:] = a[perm]
    b[:, :3] += rng.integers(0, 2, (n, 3))      # near copies, some exact
    b[n // 2: n // 2 + 5] = b[n // 2 - 5: n // 2]    # duplicate columns
    va = np.ones(m, bool)
    vb = np.ones(n, bool)
    if invalid:
        # an invalid row and an invalid column are near copies, so their
        # penalties cancel and they stay each other's neighbours
        vb[::7] = False
        va[perm[~vb]] = False
    return a, b, va, vb


def _pen(x, v):
    return np.concatenate([x, np.where(v, 0.0, 1e4)[:, None]], 1).astype(
        np.float32)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("m,n,tile", [(300, 200, 128), (256, 128, 128)])
def test_nn_dists_matches_pallas_interpret(d, m, n, tile):
    a, b, va, vb = _case(m, n, d, d + m)
    ap, bp = _pen(a, va), _pen(b, vb)
    ref = jpm.pallas_nn_dists(jnp.asarray(ap), jnp.asarray(bp), tile=tile,
                              interpret=True)
    got = tm.nn_dists(torch.from_numpy(ap), torch.from_numpy(bp))
    a2, b2 = (ap * ap).sum(1), (bp * bp).sum(1)
    scales = (a2 + b2[got[0].numpy()], b2 + a2[got[2].numpy()])
    for g, r, name in zip(got, ref, ("nn01", "d01", "nn10", "d10")):
        g, r = g.numpy(), np.asarray(r)
        if name.startswith("nn"):
            np.testing.assert_array_equal(g, r, name)
        else:
            # relative to the operands: an invalid row meeting an invalid
            # column cancels two 1e8 penalties and keeps their rounding
            scale = np.maximum(np.abs(r), scales[name == "d10"])
            assert np.all(np.abs(g - r) <= 1e-5 * scale), name


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("max_distance", [1.5, 5.0, float("inf")])
def test_mutual_nn_fused_matches_pallas_and_dense(d, max_distance):
    a, b, va, vb = _case(300, 200, d, d)
    args = tuple(map(jnp.asarray, (a, b, va, vb)))
    nn_p, ok_p = jpm.pallas_mutual_nn(*args, max_distance, tile=128,
                                      interpret=True)
    nn_d, ok_d = jm.mutual_nn_match(*args, max_distance)
    nn, ok = tm.mutual_nn_fused(*map(torch.from_numpy, (a, b, va, vb)),
                                max_distance)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(nn_p))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_p))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_d))
    # the dense matcher points invalid rows elsewhere; valid rows agree
    np.testing.assert_array_equal(nn.numpy()[va], np.asarray(nn_d)[va])
    assert int(ok.sum()) > 0


def test_batched_fused_equals_per_pair():
    cases = [_case(60, 40, 64, s) for s in (1, 2)]
    stack = [torch.from_numpy(np.stack([c[i] for c in cases]))
             for i in range(4)]
    nn, ok = tm.mutual_nn_fused(*stack, 3.0)
    for i, c in enumerate(cases):
        nn_i, ok_i = tm.mutual_nn_fused(*map(torch.from_numpy, c), 3.0)
        assert torch.equal(nn[i], nn_i) and torch.equal(ok[i], ok_i)


def test_port_ignores_the_tpu_kernels_phantom_rows():
    """Unit-norm descriptors at ragged shapes: the TPU kernel's zero-padded
    rows (distance |a|^2 = 1) beat the real neighbours and its indices
    leave the valid range; the port's stay inside and equal the dense
    argmin."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 64)).astype(np.float32)
    b = rng.normal(size=(200, 64)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    nn01_tpu = np.asarray(jpm.pallas_nn_dists(
        jnp.asarray(a), jnp.asarray(b), tile=128, interpret=True)[0])
    assert nn01_tpu.max() >= 200
    nn01, _, nn10, _ = tm.nn_dists(torch.from_numpy(a), torch.from_numpy(b))
    assert int(nn01.max()) < 200 and int(nn10.max()) < 300
    dense = np.asarray(jm.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(nn01.numpy(), dense.argmin(1))


def test_cpu_tensors_take_the_plain_twin(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda name: 1 / 0)
    monkeypatch.setattr(cuda_match.KERNEL, "_fn", None)
    before = cuda_match.KERNEL.launches
    a, b, va, vb = _case(30, 20, 64, 5)
    ap, bp = torch.from_numpy(_pen(a, va)), torch.from_numpy(_pen(b, vb))
    for g, w in zip(cuda_match.nearest_neighbours(ap, bp),
                    tm.nn_dists(ap, bp)):
        assert torch.equal(g, w)
    assert cuda_match.KERNEL.launches == before
