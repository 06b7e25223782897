"""A CPU mirror of kernel D's block decomposition (csrc/match.cu), held
against the plain `nn_dists` and the JAX Pallas kernel in interpret mode.

The CUDA kernel runs only on the card. This mirror repeats its plan in
numpy so that the plan is tested here: score tiles of the kernel's own
sizes (read from the source), 2-D over row and column tiles; depth slices
summed in feature order by fmaf (emulated in float64, where the product
of two f32 values is exact); norms from the same slices; padded rows and
columns at +inf with their own indices; and per-tile row and column minima
merged through 64-bit (order-preserving float bits, index) keys by a min
taken in a random block order, as the kernel's atomicMin merges them in
whatever order the blocks finish.

Integer descriptors make every sum exact in f32, so there the mirror must
equal `nn_dists` bit for bit, ties included (the first index wins). Real
descriptors keep the card's rule (test_torch_kernels_cuda `_check_nn`):
indices equal except near ties (the two candidates' distances within 1e-5
of |a|^2 + |b|^2), distances within 1e-5 of that scale.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoint_bench_tpu.ops import pallas_match as jpm
from keypoint_bench_tpu_torch.ops import _build
from keypoint_bench_tpu_torch.ops.matching import nn_dists
from tests.test_torch_kernels_cuda import _check_nn
from tests.test_torch_nn_match import _case, _pen


def _tile_sizes():
    with open(os.path.join(_build.CSRC_DIR, "match.cu")) as f:
        src = f.read()
    return tuple(int(re.search(rf"^#define {name} (\d+)", src, re.M)[1])
                 for name in ("TM", "TN", "TK"))


TM, TN, TK = _tile_sizes()
ALL_ONES = np.uint64(2 ** 64 - 1)


def order_bits(v):
    """match.cu `order_bits`: f32 -> u32, monotone in the value; -0 is +0."""
    u = (np.asarray(v, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def from_order_bits(o):
    o = np.asarray(o, np.uint32)
    return np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o).astype(
        np.uint32).view(np.float32)


def make_key(v, idx):
    return ((order_bits(v).astype(np.uint64) << np.uint64(32))
            | np.asarray(idx).astype(np.uint64))


def decode(keys):
    return ((keys & np.uint64(0xFFFFFFFF)).astype(np.int32),
            from_order_bits((keys >> np.uint64(32)).astype(np.uint32)))


def mirror_nn_dists(a, b, rng):
    """a [M, D], b [N, D] f32 -> (nn01, d01, nn10, d10) by kernel D's plan,
    the blocks taken in the order `rng` draws."""
    m, d = a.shape
    n = b.shape[0]
    rt, ct = -(-m // TM), -(-n // TN)
    ap = np.zeros((rt * TM, d), np.float32)
    bp = np.zeros((ct * TN, d), np.float32)
    ap[:m], bp[:n] = a, b
    rowkey = np.full(m, ALL_ONES)
    colkey = np.full(n, ALL_ONES)
    for t in rng.permutation(rt * ct):
        i0, j0 = (t // ct) * TM, (t % ct) * TN
        at, bt = ap[i0:i0 + TM], bp[j0:j0 + TN]
        dot = np.zeros((TM, TN), np.float32)
        a2 = np.zeros(TM, np.float32)
        b2 = np.zeros(TN, np.float32)
        for k0 in range(0, d, TK):
            for k in range(k0, min(k0 + TK, d)):    # the slice's live features
                x, y = at[:, k].astype(np.float64), bt[:, k].astype(np.float64)
                dot = (dot + x[:, None] * y[None, :]).astype(np.float32)
                a2 = (a2 + x * x).astype(np.float32)
                b2 = (b2 + y * y).astype(np.float32)
        rows, cols = i0 + np.arange(TM), j0 + np.arange(TN)
        a2 = np.where(rows < m, a2, np.float32(np.inf))
        b2 = np.where(cols < n, b2, np.float32(np.inf))
        s = (a2[:, None] + b2[None, :]) - np.float32(2.0) * dot
        rk = make_key(s, np.broadcast_to(cols[None, :], s.shape)).min(1)
        ck = make_key(s, np.broadcast_to(rows[:, None], s.shape)).min(0)
        live_r, live_c = rows < m, cols < n
        rowkey[rows[live_r]] = np.minimum(rowkey[rows[live_r]], rk[live_r])
        colkey[cols[live_c]] = np.minimum(colkey[cols[live_c]], ck[live_c])
    return (*decode(rowkey), *decode(colkey))


def _descs(m, n, d, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        return [rng.integers(-3, 4, (r, d)).astype(np.float32)
                for r in (m, n)]
    out = [rng.normal(size=(r, d)).astype(np.float32) for r in (m, n)]
    return [x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-6)
            for x in out]


def _plain(a, b):
    return [t.numpy() for t in nn_dists(torch.from_numpy(a),
                                        torch.from_numpy(b))]


def _check(got, want, a, b):
    _check_nn([torch.from_numpy(x) for x in got],
              [torch.from_numpy(x) for x in want], torch.from_numpy(a),
              torch.from_numpy(b))


def test_tiles_are_the_kernels():
    assert (TM, TN, TK) == (128, 128, 16)


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (1, 129, 3), (127, 129, 5),
                                   (129, 127, 17), (300, 260, 65),
                                   (1000, 1000, 8)])
@pytest.mark.parametrize("integer", [True, False])
def test_mirror_matches_nn_dists(m, n, d, integer):
    a, b = _descs(m, n, d, m * 7 + n + d, integer)
    got = mirror_nn_dists(a, b, np.random.default_rng(d))
    want = _plain(a, b)
    if integer:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        _check(got, want, a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirror_first_index_across_tiles(seed):
    """Equal rows and equal columns in far-apart tiles, merged in three
    block orders: the first index wins in both directions."""
    a, b = _descs(300, 290, 9, 40 + seed, True)
    a[280], a[150] = a[3], a[3]          # rows in tiles 0, 1 and 2
    b[260], b[140] = b[5], b[5]          # columns in tiles 0, 1 and 2
    b[200] = a[280]                      # exact copies: s = 0 for 3 rows
    want = _plain(a, b)
    assert want[0][3] == want[0][150] == want[0][280] == 200
    assert want[2][200] == 3
    got = mirror_nn_dists(a, b, np.random.default_rng(seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mirror_all_ties():
    """Every distance equal: row and column minima pick index 0 from the
    first tile, whatever order the tiles merge in."""
    a = np.ones((260, 4), np.float32)
    b = np.ones((300, 4), np.float32)
    nn01, d01, nn10, d10 = mirror_nn_dists(a, b, np.random.default_rng(0))
    assert not nn01.any() and not nn10.any()
    assert not d01.any() and not d10.any()


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("m,n,tile", [(300, 200, 128), (256, 128, 128)])
def test_mirror_matches_pallas_interpret(d, m, n, tile):
    """At the shapes and tolerances of test_torch_nn_match's comparison of
    `nn_dists` with the TPU kernel (where its zero-padded phantom rows
    stay behind the real neighbours)."""
    a, b, va, vb = _case(m, n, d, d + m)
    ap, bp = _pen(a, va), _pen(b, vb)
    ref = jpm.pallas_nn_dists(jnp.asarray(ap), jnp.asarray(bp), tile=tile,
                              interpret=True)
    got = mirror_nn_dists(ap, bp, np.random.default_rng(d))
    a2, b2 = (ap * ap).sum(1), (bp * bp).sum(1)
    scales = (a2 + b2[got[0]], b2 + a2[got[2]])
    for g, r, name in zip(got, ref, ("nn01", "d01", "nn10", "d10")):
        r = np.asarray(r)
        if name.startswith("nn"):
            np.testing.assert_array_equal(g, r, name)
        else:
            scale = np.maximum(np.abs(r), scales[name == "d10"])
            assert np.all(np.abs(g - r) <= 1e-5 * scale), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_order_is_value_then_index(seed):
    """Keys sort as (value, index) pairs, for negatives (s is not clamped),
    -0 beside +0, +-inf, subnormals and the largest finite values; decode
    gives the pair back, -0 as +0."""
    rng = np.random.default_rng(seed)
    special = np.array([-np.inf, -3.4e38, -1.0, -1e-45, -0.0, 0.0, 1e-45,
                        1e-38, 1.0, 1e8, 3.4e38, np.inf], np.float32)
    v = np.concatenate([special, rng.normal(size=200).astype(np.float32)
                        * np.float32(10.0) ** rng.integers(-5, 6, 200)])
    v = rng.choice(v, 400).astype(np.float32)
    idx = rng.integers(0, 5, v.size)
    keys = make_key(v, idx)
    order = np.argsort(keys, kind="stable")
    pairs = sorted(range(v.size), key=lambda i: (float(v[i]), int(idx[i]),
                                                 i))
    vk, ik = v[order], idx[order]
    vp, ip = v[pairs], idx[pairs]
    assert np.array_equal(vk, vp) and np.array_equal(ik, ip)
    nn, back = decode(keys)
    assert np.array_equal(nn, idx) and np.array_equal(back, v)
    assert not np.signbit(back[v == 0]).any()
    assert make_key(np.float32(-0.0), 3) == make_key(np.float32(0.0), 3)
    assert make_key(np.float32(-0.0), 2) < make_key(np.float32(0.0), 3)
