#!/usr/bin/env python3
"""Kernel B (csrc/sample.cu) against another source of the same kernel, in
turns on one card.

    python tools/sample_turns.py OTHER.cu [--wrapper OTHER.py] [--iters 20]

OTHER.cu is another revision of keypoint_bench_tpu_torch/csrc/sample.cu
with the same C entry point `kbt_sample` (for example a parent commit's,
unpacked with `git archive` into a git-ignored directory); OTHER.py, if
given, is that revision's ops/cuda_sample.py, so that its wrapper's host
work is timed too. Both sources are built with the port's nvcc flags.
The inputs are the main path's: ALIKE-t's branch features of 16
synthetic homography images at 512^2 (`weights_npz/Alike.npz`) and the
keypoints `detection_batch` finds there (nms 6, border 8, top_k 1000),
in the original and the y-sorted order. Both kernels are held against
the plain `sample_branches` within 1e-5 there and on random branches of
96^2 and 64^2 images (last branch 3 x 3 and 2 x 2). Then, in each order,
they are timed in turns (other, this, this, other; CUDA events, mean of
`--iters` back-to-back calls each):
  * `launch`: the C entry point called with arguments made once, so the
    host adds little beside the launch;
  * `wrapper`: `sample_cuda` of each revision, as the main path calls it.
After all event timings, each kernel's device time of a call comes from
torch.profiler over 10 calls, and each wrapper's host time of a call from
the host clock over 100 calls issued without a synchronize (too few to
fill the launch queue, so the host never waits for the card). Prints
chip_smoke's two bounds and one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 512


def build(src: str, argtypes) -> ctypes.CDLL:
    from keypoint_bench_tpu_torch.ops import _build
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libsample_turns_{tag}.so")
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True)
    lib = ctypes.CDLL(out)
    lib.kbt_sample.argtypes = argtypes
    lib.kbt_sample.restype = ctypes.c_int
    lib.kbt_error_string.argtypes = [ctypes.c_int]
    lib.kbt_error_string.restype = ctypes.c_char_p
    return lib


def launcher(lib, feats, px, py, h, w):
    """A call of `lib`'s kbt_sample with every argument made once."""
    import torch
    from keypoint_bench_tpu_torch.ops.cuda_sample import launch_args
    nb = len(feats)
    b, k, c, hs, ws, sy, sx = launch_args(
        tuple(f.shape for f in feats), px.shape, py.shape, h, w)
    out = torch.empty((b, nb * c, k), dtype=torch.float32, device=px.device)
    args = ((ctypes.c_void_p * nb)(*[f.data_ptr() for f in feats]), hs, ws,
            sy, sx, nb, c, h, w, px.data_ptr(), py.data_ptr(),
            out.data_ptr(), b, k, torch.cuda.current_stream().cuda_stream)

    def call():
        code = lib.kbt_sample(*args)
        if code:
            raise RuntimeError(f"kbt_sample: {lib.kbt_error_string(code)}")
        return out
    return call


def host_us(fn, calls=100):
    """Host microseconds a call of fn(), issued back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def other_wrapper(path, lib):
    """The other revision's ops/cuda_sample.py, its kernel bound to `lib`."""
    spec = importlib.util.spec_from_file_location("other_cuda_sample", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.KERNEL._fn, mod.KERNEL._err = lib.kbt_sample, lib.kbt_error_string
    return mod.sample_cuda


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sample_turns: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--wrapper", default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from keypoint_bench_tpu_torch.datasets import get_dataset
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops import _build, cuda_sample
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch)
    from keypoint_bench_tpu_torch.ops.sparse_desc import (row_tap_keys,
                                                          sample_branches)
    from keypoint_bench_tpu_torch.weights import load_params

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    argtypes = cuda_sample.KERNEL.argtypes
    libs = {"other": build(args.other, argtypes),
            "this": build(os.path.join(_build.CSRC_DIR, "sample.cu"),
                          argtypes)}
    wrappers = {"this": cuda_sample.sample_cuda}
    if args.wrapper:
        wrappers["other"] = other_wrapper(args.wrapper, libs["other"])

    ds = get_dataset({"type": "synthetic_homography", "num_pairs": 16,
                      "image_size": SIZE})
    imgs = torch.from_numpy(np.stack([ds[i]["image0"]
                                      for i in range(16)])).to(dev)
    model = get_model("Alike")(load_params("Alike", device=dev)).eval()
    with torch.inference_mode():
        score, feats = model.feats(imgs)
        kpts, _ = detection_batch(score, DetectParams(nms_dist=6,
                                                      border_dist=8,
                                                      top_k=1000))
    feats = tuple(f.contiguous() for f in feats)
    px = (kpts[..., 0] * (SIZE - 1.0)).contiguous()
    py = (kpts[..., 1] * (SIZE - 1.0)).contiguous()
    order = torch.sort(row_tap_keys(kpts, SIZE), dim=1, stable=True)[1]
    orders = {"y-sorted": (px.gather(1, order), py.gather(1, order)),
              "original": (px, py)}

    gen = torch.Generator(device=dev).manual_seed(1)
    checks = {}
    for lo in (3, 2):
        sz = 32 * lo
        tiny = tuple(torch.rand((2, 16, sz // r, sz // r), device=dev,
                                generator=gen) for r in (1, 2, 8, 32))
        tx, ty = (torch.rand((2, 300), device=dev, generator=gen) * (sz - 1)
                  for _ in range(2))
        checks[f"{sz}^2"] = (tiny, tx, ty, sz)
    for name, (x, y) in orders.items():
        checks[name] = (feats, x, y, SIZE)
    errs = {}
    for case, (f, x, y, sz) in checks.items():
        want = sample_branches(f, x, y, sz, sz)
        for rev, lib in libs.items():
            err = float((launcher(lib, f, x, y, sz, sz)() - want).abs().max())
            errs[f"{rev} {case}"] = err
            if not err <= 1e-5:
                raise AssertionError(f"{rev} differs from sample_branches "
                                     f"on {case}: {err}")
        print(f"{case}: max abs err " + ", ".join(
            f"{rev} {errs[f'{rev} {case}']:.3g}" for rev in libs),
            flush=True)

    rows = {}
    for name, (x, y) in orders.items():
        calls = {("launch", rev): launcher(lib, feats, x, y, SIZE, SIZE)
                 for rev, lib in libs.items()}
        for rev, fn in wrappers.items():
            calls[("wrapper", rev)] = (lambda fn=fn, x=x, y=y: fn(
                feats, x, y, SIZE, SIZE))
        row = {}
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader", "-lms", "50"],
            stdout=subprocess.PIPE, text=True)
        for how in ("launch", "wrapper"):
            if (how, "other") not in calls:
                row[f"{how}_this_ms"] = cs.cuda_ms(calls[(how, "this")],
                                                   iters=args.iters)
                continue
            other_ms, this_ms, turns = cs.in_turns(
                calls[(how, "other")], calls[(how, "this")],
                iters=args.iters, other_iters=args.iters)
            row[f"{how}_other_ms"], row[f"{how}_this_ms"] = other_ms, this_ms
            row[f"{how}_turns_other_this_this_other"] = turns
        smi.terminate()
        row["sm_clock_power_during_turns"] = \
            smi.communicate()[0].strip().splitlines()
        rows[name] = row
    for name, (x, y) in orders.items():
        for rev, lib in libs.items():
            call = launcher(lib, feats, x, y, SIZE, SIZE)
            busy, _, kernels = cs.profile_step(
                lambda: [call() for _ in range(10)])
            rows[name][f"device_{rev}_ms"] = busy / 10
            rows[name][f"kernels_{rev}"] = [(n, t / 10) for n, t in kernels]
        x, y = orders[name]
        for rev, fn in wrappers.items():
            rows[name][f"wrapper_{rev}_host_us"] = host_us(
                lambda: fn(feats, x, y, SIZE, SIZE))
        rows[name]["launch_this_host_us"] = host_us(
            launcher(libs["this"], feats, x, y, SIZE, SIZE))
        rows[name]["bound_ms"], rows[name]["bound_by"] = cs.sample_bound(
            feats, x, y, SIZE, SIZE)
        (rows[name]["sector_bound_ms"], rows[name]["sector_bound_by"],
         rows[name]["sector_bytes"]) = cs.sample_sector_bound(
            feats, x, y, SIZE, SIZE)
        print(json.dumps({"order": name, **rows[name]}), flush=True)
    print(card)
    print(json.dumps({"card": card, "other": args.other,
                      "wrapper": args.wrapper, "max_abs_err": errs,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
