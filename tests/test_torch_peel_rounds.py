"""Kernel C's round structure (csrc/peel.cu), mirrored in torch on the CPU.

`_mirror_peel` follows the kernel step by step: a warp per row walking
groups of up to four 128-column chunks, lane l holding columns 4l..4l+3 of
each chunk; one ballot of isnan filling a NaN chunk with (NaN, W); per
round the lanes' best values as order-preserving 32-bit keys and one
maximum over them, compared back as f32 (so -0.0 ties with +0.0, as the
reference's `==` has it); a -inf maximum (every value -inf by
then) filling the remaining rounds with the chunk's first column; a lone
match (one lane holds the maximum, once) taking slot j; otherwise every
value equal to the maximum leaving in that round, ranked by the matches at
lower columns (popcounts of four ballots below the lane plus the lane's
own earlier matches), up to the slots left; candidates staged per row at
blk * per_chunk + j.

Tolerance: none. The peel only compares, selects and masks, so the mirror's
values equal `detect.peel_topk`'s and the JAX `_peel_kernel`'s (Pallas,
interpret mode) under `==`, NaN matching NaN (-0.0 equals +0.0 there, as
the reference's `==` has it), and indices are equal.
"""
import functools
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from jax.experimental import pallas as pl

from keypoint_bench_tpu.ops.pallas_nms import _peel_kernel
from keypoint_bench_tpu_torch.ops import detect as td


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, GROUP = 128, 4
SIGN = 0x80000000
MASK32 = 0xFFFFFFFF
NEG_INF_KEY = 0x007FFFFF
# (W, per_chunk): every W with per_chunk 1, 8 and 32 where the shape rule
# (W // 128) * per_chunk <= 128 allows it, and the whole chunk at W = 128
SHAPES = [(w, pc) for w in (128, 384, 512, 2048) for pc in (1, 8, 32)
          if (w // CHUNK) * pc <= CHUNK] + [(128, 128)]
H = 24          # border 8 keeps rows 8..15, where the special rows lie


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 (no NaN) -> the kernel's unsigned keys, as int64 in
    [0, 2**32)."""
    u = x.contiguous().view(torch.int32).long() & MASK32
    s = torch.where(u & SIGN != 0, MASK32, 0)
    return u ^ (s | SIGN)


def key_values(k: torch.Tensor) -> torch.Tensor:
    u = k ^ torch.where(k & SIGN != 0, SIGN, MASK32)
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.int().view(torch.float32)


def _popc(x: torch.Tensor) -> torch.Tensor:
    return sum((x >> s) & 1 for s in range(32))


def _ballot(pred: torch.Tensor) -> torch.Tensor:
    """[N, 32] bool -> [N] int64 ballot of the 32 lanes."""
    return (pred.long() << torch.arange(32)).sum(-1)


def _peel_chunks(v, nan, blk, w, per_chunk):
    """The rounds of N chunks at once. v [N, 32, 4] f32 values (lane, q),
    border-masked; nan [N] the isnan ballot; blk [N]
    column blocks. Returns (vals [N, per_chunk], idx, rounds [N]); a chunk
    leaves the loop where the kernel's warp does."""
    n = v.shape[0]
    v = v.clone()
    ov = torch.full((n, per_chunk), 7.0)          # every slot is written
    oi = torch.full((n, per_chunk), -1, dtype=torch.int64)
    ov[nan], oi[nan] = float("nan"), w
    rounds = nan.long()                            # the ballot settles it
    j = torch.zeros(n, dtype=torch.int64)
    live = ~nan
    lanes = torch.arange(32)
    lt = (1 << lanes) - 1                          # lanemask_lt
    col0 = blk[:, None] * CHUNK + 4 * lanes[None, :]          # [N, 32]
    slot = torch.arange(per_chunk)
    while bool(live.any()):
        best = v.amax(2)                                       # [N, 32]
        m = key_values(order_keys(best).amax(1))   # __reduce_max_sync
        e = v == m[:, None, None]
        rounds += live.long()
        # a -inf maximum: every value is -inf, so the chunk's first
        # column fills every remaining slot
        fill = live & (m == -torch.inf)
        assert bool((v[fill] == -torch.inf).all())
        rest = fill[:, None] & (slot[None, :] >= j[:, None])
        ov[rest] = float("-inf")
        oi[rest] = (blk[:, None] * CHUNK).expand(-1, per_chunk)[rest]
        # one value equals the maximum: its lane takes slot j
        held = _ballot(best == m[:, None])
        two = _ballot(e.sum(2) >= 2) != 0
        single = live & ~fill & ((held & (held - 1)) == 0) & ~two
        q_one = e.long().argmax(2)                             # [N, 32]
        hit = single[:, None] & (best == m[:, None])
        r, ln = hit.nonzero(as_tuple=True)
        ov[r, j[r]] = m[r]
        oi[r, j[r]] = col0[r, ln] + q_one[r, ln]
        v = torch.where(single[:, None, None] & e, -torch.inf, v)
        # ties: slot j + the matches at lower columns, from the ballots
        batch = live & ~fill & ~single
        b = torch.stack([_ballot(e[:, :, q]) for q in range(4)], 1)
        pos = j[:, None] + _popc(b[:, None, :] & lt[None, :, None]).sum(2)
        for q in range(4):
            hit = e[:, :, q] & batch[:, None]
            take = hit & (pos < per_chunk)
            r, ln = take.nonzero(as_tuple=True)
            ov[r, pos[r, ln]] = m[r]
            oi[r, pos[r, ln]] = col0[r, ln] + q
            v[:, :, q] = torch.where(take, -torch.inf, v[:, :, q])
            pos = pos + hit.long()
        j = torch.where(batch, j + _popc(b).sum(1), j)
        j = torch.where(single, j + 1, j)
        live = (single | batch) & (j < per_chunk)
    return ov, oi, rounds


def _mirror_peel(nms: torch.Tensor, border: int, per_chunk: int):
    """(vals [B,H,n_blk*per_chunk] f32, idx int32, rounds [B,H,n_blk]) by
    kernel C's steps; rows of the border band are not read."""
    b, h, w = nms.shape
    n_blk = w // CHUNK
    rows = torch.arange(h)
    row_keep = (rows >= border) & (rows < h - border)
    staged_v = torch.zeros((b, h, n_blk * per_chunk))
    staged_i = torch.zeros((b, h, n_blk * per_chunk), dtype=torch.int64)
    rounds = torch.zeros((b, h, n_blk), dtype=torch.int64)
    for g in range(0, n_blk, GROUP):
        for blk in range(g, min(g + GROUP, n_blk)):
            x = nms[:, :, blk * CHUNK:(blk + 1) * CHUNK].float()
            x = torch.where(row_keep[None, :, None], x, 0.0)   # not loaded
            col = blk * CHUNK + torch.arange(CHUNK)
            x = torch.where((col >= border) & (col < w - border), x, 0.0)
            x = x.reshape(b * h, 32, 4)             # [row, lane, q]
            nan = _ballot(torch.isnan(x).any(2)) != 0
            v, i, r = _peel_chunks(x, nan, torch.full((b * h,), blk), w,
                                   per_chunk)
            s = slice(blk * per_chunk, (blk + 1) * per_chunk)
            staged_v[:, :, s] = v.reshape(b, h, per_chunk)
            staged_i[:, :, s] = i.reshape(b, h, per_chunk)
            rounds[:, :, blk] = r.reshape(b, h)
    return staged_v, staged_i.int(), rounds


def _maps(w, seed):
    """[7, H, w] f32: smooth, bf16-tie-heavy, sparse, all-zero, NMS'd,
    signed, and a map of special rows (in rows 8..15): -inf with a few
    finite values, a NaN inside a chunk, a NaN in the border columns,
    -0.0 beside +0.0, ±0 with subnormals, +inf ties."""
    rng = np.random.default_rng(seed)
    base = rng.random((7, H, w)).astype(np.float32)
    smooth = ndi.gaussian_filter(base, (0, 2.0, 2.0)).astype(np.float32)
    m = np.zeros((7, H, w), np.float32)
    m[0] = smooth[0]
    m[1] = torch.from_numpy(ndi.gaussian_filter(
        base[1], 1.0)).bfloat16().float().numpy()
    m[2] = np.where(base[2] > 0.97, base[2], 0.0)
    m[4] = td.fast_nms(torch.from_numpy(smooth[4:5]), 4, 30)[0].numpy()
    m[5] = smooth[5] - 0.5
    s = smooth[6].copy()
    s[8] = -np.inf
    s[8, [20, 45, 90]] = [0.5, 0.25, 0.25]
    s[8, w - 40] = 0.125
    s[9, w // 2 + 3] = np.nan
    s[10, 2] = np.nan
    s[11] = np.where(np.arange(w) % 2 == 0, np.float32(-0.0), 0.0)
    s[12] = np.where(np.arange(w) % 3 == 0, np.float32(-0.0), 0.0)
    s[12, 17::29] = np.float32(1e-45)
    s[12, 23::31] = np.float32(-1e-45)
    s[13, [30, 31, 70]] = np.inf
    s[14] = np.float32(-0.0)
    m[6] = s
    return torch.from_numpy(m)


# values equal under ==, NaN matching NaN; indices equal
SMOKE = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                       run_name="not_main")
_peel_equal = SMOKE["peel_equal"]


@functools.lru_cache(maxsize=None)
def _pallas_peel(h, w, border, per_chunk):
    return jax.jit(pl.pallas_call(
        functools.partial(_peel_kernel, border=border, per_chunk=per_chunk),
        out_shape=(jax.ShapeDtypeStruct((h, 128), jnp.float32),
                   jax.ShapeDtypeStruct((h, 128), jnp.int32)),
        interpret=True))


@pytest.mark.parametrize("border", [0, 4, 8])
@pytest.mark.parametrize("w,per_chunk", SHAPES)
def test_mirror_equals_peel_topk(w, per_chunk, border):
    maps = _maps(w, w + per_chunk)
    v, i, rounds = _mirror_peel(maps, border, per_chunk)
    pv, pi = td.peel_topk(maps, border, per_chunk)
    assert _peel_equal(v, i, pv, pi)
    assert int(rounds.min()) >= 1 and int(rounds.max()) <= per_chunk
    # the NaN chunk: (NaN, W) in every round; the border masks the other
    nan_blk = (w // 2 + 3) // CHUNK
    s = slice(nan_blk * per_chunk, (nan_blk + 1) * per_chunk)
    assert bool(torch.isnan(v[6, 9, s]).all()) and bool((i[6, 9, s] == w).all())
    assert bool(torch.isnan(v[6, 10, :per_chunk]).all()) == (border <= 2)


def _flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU backend flushes f32 subnormals to zero, so the JAX
    reference compares them as 0 there; the port keeps them (IEEE, as
    `peel_topk` does on either device). Both sides of a comparison with
    the JAX kernel get the flushed map."""
    sub = (x != 0) & (x.abs() < torch.finfo(torch.float32).tiny)
    return torch.where(sub, torch.copysign(torch.zeros_like(x), x), x)


@pytest.mark.parametrize("w,per_chunk", SHAPES)
def test_mirror_equals_pallas_interpret(w, per_chunk):
    border = (0, 4, 8)[SHAPES.index((w, per_chunk)) % 3]
    maps = _flush_subnormals(_maps(w, w + per_chunk))
    v, i, _ = _mirror_peel(maps, border, per_chunk)
    nc = (w // CHUNK) * per_chunk
    fn = _pallas_peel(H, w, border, per_chunk)
    for b in range(maps.shape[0]):
        jv, ji = fn(jnp.asarray(maps[b].numpy()))
        assert _peel_equal(v[b], i[b], torch.from_numpy(np.array(jv)[:, :nc]),
                     torch.from_numpy(np.array(ji)[:, :nc]))


def test_minus_inf_nan_and_signed_zero_rules():
    """The reference's edge rules, spelled out: the -inf repeat, (NaN, W)
    in every round of a NaN chunk, -0.0 tying with +0.0 by column."""
    m = torch.full((1, 8, 256), -torch.inf)
    m[0, :, 40] = 0.25
    m[0, 3, 7] = 0.5
    m[0, 5, 130] = torch.nan
    m[0, 6] = 0.0
    m[0, 6, ::2] = -0.0
    m[0, 6, 200] = 0.75
    v, i, rounds = _mirror_peel(m, 0, 4)
    assert i[0, 3].tolist() == [7, 40, 0, 0, 128, 128, 128, 128]
    assert v[0, 3, 2:4].tolist() == [-np.inf, -np.inf]
    assert i[0, 5, 4:].tolist() == [256] * 4
    assert bool(torch.isnan(v[0, 5, 4:]).all())
    assert i[0, 6].tolist() == [0, 1, 2, 3, 200, 128, 129, 130]
    assert rounds[0, 3].tolist() == [3, 1] and rounds[0, 5].tolist() == [2, 1]
    assert rounds[0, 6].tolist() == [1, 2]
    pv, pi = td.peel_topk(m, 0, 4)
    assert _peel_equal(v, i, pv, pi)
    jv, ji = _pallas_peel(8, 256, 0, 4)(jnp.asarray(m[0].numpy()))
    assert _peel_equal(v[0], i[0], torch.from_numpy(np.array(jv)[:, :8]),
                 torch.from_numpy(np.array(ji)[:, :8]))


def test_order_keys_are_monotone():
    """Over a sweep of f32 values: the keys order as the floats, -0.0
    just below +0.0, and each key maps back to its value's bits."""
    tiny = np.float32(1e-45)
    big = np.finfo(np.float32).max
    pos = np.array([0.0, tiny, 2 * tiny, np.finfo(np.float32).tiny / 2,
                    np.finfo(np.float32).tiny, 1e-30, 0.5, 1.0, 1.5, 1e30,
                    big, np.inf], np.float32)
    sweep = np.concatenate([-pos[::-1], pos]).astype(np.float32)
    keys = order_keys(torch.from_numpy(sweep))
    assert all(x > 0 for x in torch.diff(keys).tolist())
    assert int(keys[0]) == NEG_INF_KEY and int(keys.max()) < 2 ** 32
    back = key_values(keys).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), sweep.view(np.uint32))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    x = x[~np.isnan(x)]
    k = order_keys(torch.from_numpy(x)).numpy()
    o = np.argsort(k, kind="stable")
    assert (np.diff(x[o].astype(np.float64)) >= 0).all()


@pytest.mark.parametrize("w,per_chunk", [(512, 8), (128, 128)])
def test_rounds_reckoned_from_the_candidates(w, per_chunk):
    """chip_smoke.py's `peel_rounds`, reckoned from the plain peel's
    candidates, counts the mirror's rounds chunk by chunk; on an NMS'd
    map most chunks take far fewer rounds than per_chunk."""
    maps = _maps(w, 5)
    for border in (0, 8):
        _, _, rounds = _mirror_peel(maps, border, per_chunk)
        pv, _ = td.peel_topk(maps, border, per_chunk)
        assert torch.equal(SMOKE["peel_rounds"](pv, per_chunk), rounds)
    assert float(rounds[4].float().mean()) < per_chunk / 2
