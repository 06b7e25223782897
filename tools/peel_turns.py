#!/usr/bin/env python3
"""Kernel C (csrc/peel.cu) against another source of the same kernel, in
turns on one card.

    python tools/peel_turns.py OTHER.cu [--iters 50]

OTHER.cu is another revision of keypoint_bench_tpu_torch/csrc/peel.cu with
the same C entry point `kbt_peel` (for example a parent commit's, unpacked
with `git archive` into a git-ignored directory). Both sources are built
with the port's nvcc flags, and this one a second time with
-DKBT_PEEL_LOAD_BAND (the border band's rows loaded, then read as 0). The
inputs are the main path's: ALIKE-t's score maps of 16 synthetic
homography images at 512^2 (`weights_npz/Alike.npz`) through kernel A
(nms 6), peeled with border 8 and per_chunk 8. Every build is held
against the plain `peel_topk` (values equal under ==, NaN matching NaN;
indices equal) on those maps, on a tie-heavy and a sparse map; the maps
with NaN chunks and with -0.0 beside +0.0 are checked too, and another
revision that differs there is reported, not failed (earlier revisions
dropped NaN). Then, at border 8, two pairs are timed in turns (first,
second, second, first; CUDA events, mean of `--iters` calls of the C
entry point with arguments made once): the other revision against this
one, and this one with the band loaded against this one; and each build's
device time of a call comes from torch.profiler over 10 calls. Prints
chip_smoke's bound, the rounds per chunk the maps need (reckoned on the
host from the plain peel's candidates) and one JSON line with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import turns_common as tc

SIZE, BORDER, PER_CHUNK = 512, 8, 8


def runner(lib, maps, border):
    """A call of `lib`'s kernel C on contiguous f32 maps [B, H, W], its
    outputs made once."""
    import torch
    b, h, w = maps.shape
    nc = (w // 128) * PER_CHUNK
    vals = torch.empty((b, h, nc), dtype=torch.float32, device=maps.device)
    idx = torch.empty((b, h, nc), dtype=torch.int32, device=maps.device)

    def call():
        code = lib.kbt_peel(maps.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                            b, h, w, border, PER_CHUNK,
                            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"kbt_peel: CUDA error {code}")
        return vals, idx
    return call


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("peel_turns: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, tc.ROOT)
    import numpy as np

    import chip_smoke as cs
    from keypoint_bench_tpu_torch.datasets import get_dataset
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops import _build, cuda_nms
    from keypoint_bench_tpu_torch.ops.detect import peel_topk
    from keypoint_bench_tpu_torch.weights import load_params

    card = tc.card()
    dev = torch.device("cuda")
    P, I = ctypes.c_void_p, ctypes.c_int
    argtypes = [P, P, P, I, I, I, I, I, P]
    this = os.path.join(_build.CSRC_DIR, "peel.cu")
    libs = {"other": tc.build(args.other, "peel", "kbt_peel", argtypes),
            "this": tc.build(this, "peel", "kbt_peel", argtypes),
            "band loaded": tc.build(this, "peel", "kbt_peel", argtypes,
                                    flags=("-DKBT_PEEL_LOAD_BAND",))}

    ds = get_dataset({"type": "synthetic_homography", "num_pairs": 16,
                      "image_size": SIZE})
    imgs = torch.from_numpy(np.stack([ds[i]["image0"]
                                      for i in range(16)])).to(dev)
    model = get_model("Alike")(load_params("Alike", device=dev)).eval()
    with torch.inference_mode():
        score, _ = model.feats(imgs)
    nms = cuda_nms.nms_cuda(score[..., 0].contiguous(), 6, 30)
    gen = torch.Generator(device=dev).manual_seed(0)
    ties = (torch.round(torch.rand((2, SIZE, SIZE), device=dev,
                                   generator=gen) * 2) / 2)
    nan2 = nms[:2].clone()
    nan2[0, 100, 300] = nan2[1, 200, 130] = torch.nan
    cols = torch.arange(SIZE, device=dev)
    gated = {"NMS'd score maps x16": nms,
             "tie-heavy": cuda_nms.nms_cuda(ties, 2, 30),
             "sparse": torch.where(nms[:2] > 0.6, nms[:2], 0.0)}
    edge = {"NaN chunks": nan2,
            "-0.0 beside +0.0": torch.where((nms[:2] == 0) & (cols % 2 == 0),
                                            -0.0, nms[:2])}
    checks = {}
    for name, m in {**gated, **edge}.items():
        pv, pi = peel_topk(m, BORDER, PER_CHUNK)
        for rev, lib in libs.items():
            ok = cs.peel_equal(*runner(lib, m, BORDER)(), pv, pi)
            checks[f"{rev} {name}"] = ok
            if not ok and (rev != "other" or name in gated):
                raise AssertionError(f"{rev} differs from peel_topk on "
                                     f"{name}")
        print(f"{name}: equal to peel_topk: " + ", ".join(
            f"{rev} {checks[f'{rev} {name}']}" for rev in libs), flush=True)
    rounds = cs.peel_rounds(peel_topk(nms, BORDER, PER_CHUNK)[0], PER_CHUNK)

    calls = {rev: runner(lib, nms, BORDER) for rev, lib in libs.items()}
    rows = {}
    for first in ("other", "band loaded"):
        first_ms, this_ms, turns = cs.in_turns(
            calls[first], calls["this"], iters=args.iters,
            other_iters=args.iters)
        rows[f"{first} vs this"] = {
            "first_ms": first_ms, "this_ms": this_ms,
            "turns_first_this_this_first": turns}
    device = {}
    for rev, call in calls.items():
        device[f"device_{rev}_ms"], device[f"kernels_{rev}"] = tc.device_ms(
            call)
    for name, row in rows.items():
        print(json.dumps({"pair": name, **row}), flush=True)
    print(json.dumps(device), flush=True)
    bound_ms, bound_by = cs.peel_bound(nms, PER_CHUNK, BORDER)
    print(f"bound {bound_ms:.6f} ms ({bound_by}); rounds per chunk the maps "
          f"need, reckoned on the host: mean "
          f"{float(rounds.float().mean()):.4f}, max {int(rounds.max())}")
    print(card)
    print(json.dumps({"card": card, "other": args.other,
                      "shape": list(nms.shape), "border": BORDER,
                      "per_chunk": PER_CHUNK, "checks": checks,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "rows": rows, **device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
