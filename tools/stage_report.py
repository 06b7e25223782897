"""Where each stage of the port's batched steps spends the host's time and
leaves the card idle, read from the port's own spans
(`kbt.<layer>.<stage>`, `keypoint_bench_tpu_torch/utils/profiling.py`)
under torch.profiler, in the benchmark's cells (port_bench/).

    python tools/stage_report.py --seed <n> --workload <cell>
        [--workload <cell> ...] [--out output/stage_report.json]

For each cell, with the pool and the program as port_bench/harness.py
builds them and two warm-up steps:
- about a second of steps under the profiler, as the harness traces
  them (`trace.profile_steps`): per span its calls, host time, host self
  time (less its "kbt." children) and the card's idle time while it was
  the innermost span; per layer the idle time, and the idle time no
  "kbt." span held; kernel A's counter (rounds per map slot, tile passes
  per map);
- twelve traced stretches with the spans on and off (`profiling.span`
  replaced by its no-op), in turns: the traced step time and idle share
  each way;
- the host syncs of one step (`torch.cuda.set_sync_debug_mode("warn")`),
  each with the stage open at it and the port's innermost source line.
Once: what `profiling.span` costs the host with no profiler running and
with one, and kernel A's CUDA-event time on the first cell's score maps
with and without the counter, in turns. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from keypoint_bench_tpu_torch.ops import cuda_nms  # noqa: E402
from keypoint_bench_tpu_torch.utils import profiling  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench import program_spans as P  # noqa: E402
from port_bench import spec  # noqa: E402
from port_bench import trace as T  # noqa: E402

ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def stage_table(tl) -> dict:
    """Per "kbt." label: calls, host ms, host self ms (less its "kbt."
    children), and the card's idle ms while it was the innermost span."""
    spans = P.kbt_spans(tl)
    rows = collections.defaultdict(lambda: dict.fromkeys(
        ("calls", "host_ms", "self_ms", "idle_ms"), 0.0))
    stack = []
    for a, b, label in spans:
        while stack and stack[-1][1] <= a:
            stack.pop()
        if stack:
            rows[stack[-1][2]]["self_ms"] -= (b - a) / 1e3
        rows[label]["calls"] += 1
        rows[label]["host_ms"] += (b - a) / 1e3
        rows[label]["self_ms"] += (b - a) / 1e3
        stack.append((a, b, label))
    for label, s in P.idle_by_span(tl, spans).items():
        rows[label or "(no kbt span)"]["idle_ms"] += s * 1e3
    return dict(rows)


def syncs_by_stage(call) -> list:
    """The synchronising operations of call(), each with the innermost
    span open at it (profiling.span replaced by a recording context) and
    the port's innermost frame."""
    stack, found = [], []

    @contextlib.contextmanager
    def recording(name):
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        port = [f for f in traceback.extract_stack()[:-1]
                if "keypoint_bench_tpu_torch" in f.filename]
        src = (f"{os.path.relpath(port[-1].filename, ROOT)}:"
               f"{port[-1].lineno} {port[-1].name}" if port
               else f"{filename}:{lineno}")
        found.append({"stage": stack[-1] if stack else None,
                      "source": src,
                      "message": str(message).splitlines()[0]})

    real = profiling.span
    profiling.span = recording
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.span = real
    torch.cuda.synchronize()
    return found


def stretch(step, n: int, spans_on: bool) -> dict:
    """One traced stretch of n steps: traced ms a step and idle share."""
    real = profiling.span
    if not spans_on:
        profiling.span = lambda name: profiling._NO_SPAN
    try:
        tl = T.profile_steps(step, n)
    finally:
        profiling.span = real
    return {"spans": spans_on, "step_ms": tl.window_s * 1e3 / n,
            "idle_pct": 100.0 * (1.0 - tl.busy_s() / tl.window_s)}


def cell_report(name: str, seed: int, dev) -> tuple[dict, object]:
    cell = spec.load(name)
    batches = harness.make_batches(cell, int(seed) % (1 << 63), pin=True)
    model, step = harness.load_program(cell, dev)
    per = int(cell.traffic["pairs_per_step"])

    def one(i):
        harness.host_rows(step(harness.upload(batches[i % len(batches)],
                                              dev)), cell.task.OUTPUTS)

    for i in range(2):
        one(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(len(batches)):
        one(i)
    med = (time.perf_counter() - t0) / len(batches)
    nb = len(batches)
    n = max(nb, int(np.ceil(1.0 / max(med, 1e-3) / nb)) * nb)
    profiling.counters()
    tl = T.profile_steps(one, n)
    counters = {}
    for k, v in profiling.counters().items():
        b = int(re.match(r"kernel_A\.stats\.B(\d+)\.", k).group(1))
        counters[k] = {"rounds_by_slot": v[:b].tolist(),
                       "tile_passes": int(v[b:].sum())}
    idle = P.idle_by_span(tl, P.kbt_spans(tl))
    layers = collections.Counter()
    for label, s in idle.items():
        layers[P.layer_of(label) if label else None] += s
    idle_s = sum(b - a for a, b in tl.gaps()) / 1e6
    turns = [stretch(one, n, on)
             for on in (True, False, False, True) * 3]
    return {
        "cell": name, "seed": seed, "traced_steps": n,
        "pairs": n * per, "window_s": tl.window_s, "idle_s": idle_s,
        "idle_ms_per_pair_by_layer": {str(k): v * 1e3 / (n * per)
                                      for k, v in layers.items()},
        "idle_share_held_by_kbt": 1.0 - layers[None] / idle_s,
        "stages": stage_table(tl),
        "kernel_A_counters": counters,
        "kernel_A_tile_passes_per_map": sum(
            c["tile_passes"] for c in counters.values()) / (2 * n * per),
        "turns": turns,
        "turns_median": {
            side: {m: float(np.median([t[m] for t in turns
                                       if t["spans"] == on]))
                   for m in ("step_ms", "idle_pct")}
            for side, on in (("on", True), ("off", False))},
        "syncs": syncs_by_stage(lambda: step(harness.upload(batches[0],
                                                            dev))),
    }, (model, batches)


def span_cost(loops: int = 100_000) -> dict:
    """Host µs a span: profiling.span with no profiler and with one
    running, record_function with none, and the profiler check."""
    def per_call(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def kbt():
        with profiling.span("kbt.ops.detect"):
            pass

    def bare():
        with torch.profiler.record_function("kbt.ops.detect"):
            pass

    out = {"span_off_us": per_call(kbt, loops),
           "record_function_off_us": per_call(bare, loops),
           "profiler_check_us": per_call(torch.autograd._profiler_enabled,
                                         loops)}
    with profile(activities=ACTS):
        out["span_on_us"] = per_call(kbt, loops // 10)
    return out


def kernel_a_turns(model, batch, dev, calls: int = 50) -> dict:
    """Kernel A (d 6, 30 rounds at most) on the batch's imgs0 score maps,
    CUDA events over `calls` back-to-back launches, without and with the
    counter's stats, in turns (without, with, with, without) x 3."""
    with torch.inference_mode():
        score = model(harness.upload(batch, dev)["imgs0"])[0]
    maps = (score[..., 0] if score.dim() == 4 else score).contiguous()
    b = maps.shape[0]
    stats = torch.zeros(b + 62, dtype=torch.int32, device=dev)

    def timed(with_stats):
        s = stats if with_stats else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            cuda_nms.nms_cuda(maps, 6, 30, stats=s)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls

    timed(False)
    timed(True)
    got = {False: [], True: []}
    for _ in range(3):
        for w in (False, True, True, False):
            got[w].append(timed(w))
    plain, counted = np.median(got[False]), np.median(got[True])
    return {"shape": list(maps.shape), "ms_without": got[False],
            "ms_with": got[True], "median_without": float(plain),
            "median_with": float(counted),
            "ratio": float(counted / plain)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="output/stage_report.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_report needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    out = {"card": harness.card_line(), "torch": torch.__version__,
           "span_cost": span_cost(), "cells": []}
    first = None
    for name in args.workload:
        rep, prog = cell_report(name, args.seed, dev)
        out["cells"].append(rep)
        first = first or prog
        print(json.dumps({k: rep[k] for k in (
            "cell", "traced_steps", "idle_ms_per_pair_by_layer",
            "idle_share_held_by_kbt", "kernel_A_tile_passes_per_map",
            "turns_median")}), flush=True)
        print(f"{name}: {len(rep['syncs'])} host syncs", flush=True)
    out["kernel_A"] = kernel_a_turns(first[0], first[1][0], dev)
    print(json.dumps({"span_cost": out["span_cost"],
                      "kernel_A": out["kernel_A"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
