#!/usr/bin/env python3
"""Kernel D (csrc/match.cu) against another source of the same kernel, in
turns on one card.

    python tools/match_turns.py OTHER.cu [--iters 20]

OTHER.cu is another revision of keypoint_bench_tpu_torch/csrc/match.cu with
the same C entry point `kbt_nn_dists` (for example a parent commit's,
unpacked with `git archive` into a git-ignored directory). Both sources are
built with the port's nvcc flags, each is held against the plain
`nn_dists` (bit-equal on integer descriptors; on real ones chip_smoke's
`check_nn` rule), and then at [16, 1000, 65] (ALIKE-t, the main path's
width), [16, 1000, 257] (SuperPoint) and [16, 4096, 257] both are timed
in turns (other, this, this, other; CUDA events, mean of `--iters`
calls each) beside the library yardstick (`baddbmm`, then both minima
with their indices) and chip_smoke's bound. Descriptors are unit vectors
with 15% of the rows carrying the sqrt(1e8) penalty, from seed 0. Prints
one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import turns_common as tc

SHAPES = [(16, 1000, 65), (16, 1000, 257), (16, 4096, 257)]


def runner(lib, a, b):
    """A call of `lib`'s kernel D on a [B, M, D], b [B, N, D]; outputs and
    a [B, M + N] key scratch (enough for either revision) made once."""
    import torch
    bsz, m, d = a.shape
    n = b.shape[1]
    out = [torch.empty((bsz, r), dtype=t, device=a.device)
           for r, t in ((m, torch.int32), (m, torch.float32),
                        (n, torch.int32), (n, torch.float32))]
    keys = torch.empty((bsz, m + n), dtype=torch.int64, device=a.device)

    def call():
        code = lib.kbt_nn_dists(
            a.data_ptr(), b.data_ptr(), bsz, m, n, d,
            *(t.data_ptr() for t in out), keys.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"kbt_nn_dists: CUDA error {code}")
        return out
    return call


def descriptors(bsz, k, d, gen, integer=False):
    import torch
    if integer:
        x = torch.randint(-3, 4, (bsz, k, d - 1), generator=gen,
                          device="cuda").float()
        return torch.cat([x, torch.zeros_like(x[..., :1])], -1)
    x = torch.randn((bsz, k, d - 1), generator=gen, device="cuda")
    x = x / x.norm(dim=-1, keepdim=True)
    pen = torch.rand((bsz, k, 1), generator=gen, device="cuda") < 0.15
    return torch.cat([x, pen.float() * 1e4], -1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("match_turns: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, tc.ROOT)
    import chip_smoke as cs
    from keypoint_bench_tpu_torch.ops import _build
    from keypoint_bench_tpu_torch.ops.matching import nn_dists

    card = tc.card()
    P, I = ctypes.c_void_p, ctypes.c_int
    argtypes = [P, P, I, I, I, I, P, P, P, P, P, P]
    libs = {rev: tc.build(src, "match", "kbt_nn_dists", argtypes)
            for rev, src in (("other", args.other),
                             ("this", os.path.join(_build.CSRC_DIR,
                                                   "match.cu")))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for bsz, k, d in SHAPES:
        a, b = (descriptors(bsz, k, d, gen) for _ in range(2))
        ai, bi = (descriptors(bsz, k, d, gen, True) for _ in range(2))
        want, want_i = nn_dists(a, b), nn_dists(ai, bi)
        for name, lib in libs.items():
            got_i = [t.clone() for t in runner(lib, ai, bi)()]
            if not all(torch.equal(g, w) for g, w in zip(got_i, want_i)):
                raise AssertionError(f"{name}: integer inputs differ from "
                                     f"the plain nn_dists at {(bsz, k, d)}")
            cs.check_nn(runner(lib, a, b)(), want, a, b)

        def lib_call():
            s = torch.baddbmm((a * a).sum(-1)[..., None]
                              + (b * b).sum(-1)[:, None, :], a,
                              b.transpose(1, 2), alpha=-2.0)
            return s.min(-1), s.min(-2)

        call_other = runner(libs["other"], a, b)
        call_this = runner(libs["this"], a, b)
        other_ms, this_ms, turns = cs.in_turns(
            call_other, call_this, iters=args.iters, other_iters=args.iters)
        lib_ms = cs.cuda_ms(lib_call, iters=args.iters // 2)
        mm_ms = cs.cuda_ms(lambda: torch.baddbmm(
            b[:, :1, :1], a, b.transpose(1, 2), alpha=-2.0),
            iters=args.iters // 2)
        bound_ms, bound_by = cs.match_bound(a, b)
        row = {"shape": [bsz, k, d], "other_ms": other_ms, "ms": this_ms,
               "turns_other_this_this_other": turns, "library_ms": lib_ms,
               "baddbmm_alone_ms": mm_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        for name, call in (("other", call_other), ("this", call_this)):
            row[f"device_ms_{name}"], row[f"kernels_{name}"] = tc.device_ms(
                call, calls=1)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(card)
    print(json.dumps({"card": card, "other": args.other, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
