"""One run of one cell: set-up, the measured window, the traced stretch
(with --trace 1), the check against the plain reference, the result line.

The window is a closed loop over the cell's pool of pairs, batch after
batch: each step uploads the next batch from pinned host memory, calls the
port's step and copies the step's per-pair outputs to the host; a step's
time runs from the upload to the outputs on the host. Every step's outputs
are kept, with the keypoints and matches of each batch's first step, and
checked against the plain reference (`compare.py`) once the window has
closed, the peak memory has been read and the program's state is freed.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from port_bench import spec as spec_mod
from port_bench.generators import make_pool

FORBIDDEN = ("jax", "jaxlib", "flax", "keypoint_bench_tpu")
# the port's modules whose imported calls get spans in a traced stretch
TRACED_MODULES = ("keypoint_bench_tpu_torch.parallel.evaluate",
                  "keypoint_bench_tpu_torch.pipeline")


class NoDevice(RuntimeError):
    """The cell needs more cards than the machine has."""


@dataclass
class Run:
    """What a run measured; the metric readers take it."""
    cell: spec_mod.Cell
    setup_s: float = 0.0
    step_s: list = field(default_factory=list)
    window_s: float = 0.0
    pairs: int = 0
    timeline: object = None         # trace.Timeline of the traced stretch
    traced_batches: list = field(default_factory=list)
    calls: dict = field(default_factory=dict)
    syncs: list = field(default_factory=list)
    details: dict = field(default_factory=dict)   # batch -> reference's


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the harness must not
    load (whole names: keypoint_bench_tpu_torch is not keypoint_bench_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _pin(b: dict, pin: bool) -> dict:
    return {k: v.pin_memory() if pin and isinstance(v, torch.Tensor) else v
            for k, v in b.items()}


def upload(b: dict, dev) -> dict:
    return {k: v.to(dev, non_blocking=True) if isinstance(v, torch.Tensor)
            else v for k, v in b.items()}


def make_batches(cell, entropy: int, pin: bool, workers: int | None = None):
    """The pool rendered from the seed, cut into the traffic's batches."""
    tr = cell.traffic
    pool = make_pool(tr, entropy, workers)
    per = int(tr["pairs_per_step"])
    n = int(tr["pool_pairs"]) // per
    seeds = np.random.default_rng([entropy, 1 << 40]).integers(
        0, 1 << 62, size=n * per)
    rows = [np.arange(i * per, (i + 1) * per) for i in range(n)]
    return [_pin(cell.task.batch(pool, r, [int(s) for s in seeds[r]], tr),
                 pin) for r in rows]


def load_program(cell, dev, precision: str = "float32"):
    """The port's model on the card and its step for this cell."""
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops.detect import DetectParams
    from keypoint_bench_tpu_torch.weights.io import load_params
    cfg = cell.config
    model = get_model(cfg["model"])(load_params(cfg["model"], device=dev,
                                                precision=precision))
    match_dtype = torch.bfloat16 if (precision == "bfloat16"
                                     and cfg["sparse_desc"]) else None
    step = cell.task.port_step(model, DetectParams(**cfg["extractor"]), cfg,
                               cell.traffic, match_dtype)
    return model, step


def host_rows(out: dict, names) -> np.ndarray:
    """The step's outputs as one [outputs, B] float64 array (one copy)."""
    return torch.stack([out[k].float() for k in names]).cpu().numpy() \
        .astype(np.float64)


class Capture:
    """Keeps the keypoints and matches of chosen steps: for the window
    only, the step module's `forward_detect` and `match_block` are wrapped
    to hand their outputs to `slot` while a step runs with a slot set."""

    def __init__(self, module: str):
        import importlib
        self.mod = importlib.import_module(module)
        self.slot = None

    def _wrap(self, fn, keys):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.slot is not None:
                self.slot.update({k: v for k, v in zip(keys, out) if k})
            return out
        return wrapper

    def __enter__(self):
        self._old = (self.mod.forward_detect, self.mod.match_block)
        self.mod.forward_detect = self._wrap(
            self._old[0], ("k0", "v0", None, "k1", "v1", None))
        self.mod.match_block = self._wrap(self._old[1], ("m0", "m1", "ok"))
        return self

    def __exit__(self, *exc):
        self.mod.forward_detect, self.mod.match_block = self._old


def reference_weights(cell, dev):
    from port_bench.reference.models import load_weights
    return load_weights(f"{spec_mod.ROOT}/{cell.config['weights']}", dev)


class TF32:
    """TF32 convolutions and matmuls on (or off) inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.flags = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = self.flags


def reference_check(cell, batches, dev, answers, prog_states):
    """Run the reference for every batch and check the answers
    (compare.check)."""
    from port_bench import compare
    from port_bench.reference.steps import TAILS, front
    task = cell.traffic["task"]
    weights = reference_weights(cell, dev)
    ref_states, expected, ref_outs = {}, {}, {}
    with torch.inference_mode(), TF32(False):
        for b, hb in enumerate(batches):
            db = upload(hb, dev)
            ref_states[b] = front(cell.config, weights, task, db)
            ref_outs[b] = host_rows(TAILS[task](cell.traffic, db,
                                                ref_states[b]),
                                    cell.task.OUTPUTS)
            if len(prog_states[b].get("ok", ())) == len(db["seeds"]):
                expected[b] = host_rows(TAILS[task](cell.traffic, db,
                                                    prog_states[b]),
                                        cell.task.OUTPUTS)
            else:       # the step's matches do not cover its batch
                expected[b] = np.full_like(ref_outs[b], np.inf)
    h, w = batches[0]["imgs0"].shape[1:3]
    details = {b: {"rounds": s["rounds"].cpu(),
                   "kpts": torch.cat([s["k0"], s["k1"]]).cpu()}
               for b, s in ref_states.items()}
    cpu = {b: {k: v.cpu() for k, v in s.items()}
           for b, s in prog_states.items()}
    ref_cpu = {b: {k: v.cpu() for k, v in s.items()}
               for b, s in ref_states.items()}
    return compare.check(cell.task, answers, cpu, ref_cpu, expected,
                         ref_outs, cell.limits, h, w) + (details,)


def tf32_control(cell, batches, dev):
    """The reference in the program's place with TF32 on: (answers, its
    keypoints and matches) for every batch."""
    from port_bench.reference.steps import TAILS, front
    task = cell.traffic["task"]
    weights = reference_weights(cell, dev)
    answers, states = [], {}
    with torch.inference_mode(), TF32(True):
        for b, hb in enumerate(batches):
            db = upload(hb, dev)
            states[b] = front(cell.config, weights, task, db)
            answers.append((b, host_rows(TAILS[task](cell.traffic, db,
                                                     states[b]),
                                         cell.task.OUTPUTS)))
    return answers, states


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        control: str | None = None, device: str = "cuda",
        traffic: dict | None = None, break_step=None) -> dict:
    """One run; returns the result object. `device="cpu"` skips the look
    for a card (the harness's own tests); `traffic` overrides entries of
    the cell's traffic; `break_step(step) -> step` plants a fault."""
    cell = spec_mod.load(workload)
    if traffic:
        cell.traffic = {**cell.traffic, **traffic}
    on_card = device != "cpu"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        raise NoDevice(f"{workload} needs {cell.chips} CUDA card(s); "
                       f"torch sees {torch.cuda.device_count()}")
    dev = torch.device("cuda:0" if on_card else "cpu")
    phase = {"imports": time.perf_counter() - t0}
    entropy = int(seed) % (1 << 63)
    batches = make_batches(cell, entropy, pin=on_card,
                           workers=None if on_card else 1)
    phase["pool"] = time.perf_counter() - t0
    names = cell.task.OUTPUTS
    per = int(cell.traffic["pairs_per_step"])
    record = Run(cell)
    model = step = None
    answers, states = [], {}
    if control == "tf32":
        answers, states = tf32_control(cell, batches, dev)
    else:
        model, step = load_program(
            cell, dev, "bfloat16" if control == "bf16" else "float32")
        if break_step is not None:
            step = break_step(step)
        phase["model"] = time.perf_counter() - t0
    capture = Capture(cell.task.STEP_MODULE)

    def one_step(i):
        b = i % len(batches)
        if b not in states and capture.slot is None:
            capture.slot = states[b] = {}
        start = time.perf_counter()
        try:
            rows = host_rows(step(upload(batches[b], dev)), names)
        finally:
            capture.slot = None
        return b, rows, time.perf_counter() - start

    i = 0
    if control == "bf16":
        with capture:
            answers = [one_step(i)[:2] for i in range(len(batches))]
    elif control is None:
        for j in range(2):                  # every kernel built and warm
            host_rows(step(upload(batches[j % len(batches)], dev)), names)
        if on_card:
            torch.cuda.synchronize()
        record.setup_s = time.perf_counter() - t0
        phase["warm-up"] = record.setup_s
        with capture:
            w0 = time.perf_counter()
            while True:
                b, rows, dt = one_step(i)
                answers.append((b, rows))
                record.step_s.append(dt)
                i += 1
                if (time.perf_counter() - w0 >= seconds
                        and i >= len(batches)):
                    break
            record.window_s = time.perf_counter() - w0
        record.pairs = i * per
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded after the window: {found}")
    if trace and control is None:
        t = time.perf_counter()
        traced(record, model, one_step, answers, i,
               lambda: step(upload(batches[0], dev)))
        phase["trace"] = time.perf_counter() - t
    del model, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    readings, checks, n_bad, record.details = reference_check(
        cell, batches, dev, answers, states)
    phase["reference"] = time.perf_counter() - t
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())

    metrics = {}
    t = time.perf_counter()
    if control is None:
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = spec_mod.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    phase["metrics"] = time.perf_counter() - t
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the run: {found}")
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                "count": cell.chips if on_card else 0,
                "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(answers) * per,
              "failed": n_bad, "metrics": metrics, "device": dev_info}
    if trace and record.timeline is not None:
        dev_info["busy_s"] = record.timeline.busy_s()
        dev_info["window_s"] = record.timeline.window_s
        result["breakdown"] = record.timeline.breakdown()
    log("phases (s)", json.dumps(phase))
    if control is None:
        log(f"step samples {len(record.step_s)}, pairs {record.pairs}, "
            f"window {record.window_s} s, setup {record.setup_s} s")
    log("card", card_line() if on_card else "none")
    result["readings"] = readings
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    log("readings", json.dumps(readings))
    if not checks:
        log("check no limits for this cell: not correct")
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'OVER'}")
    return result


def traced(record: Run, model, one_step, answers, i0: int, port_call):
    """The traced stretch after the window: as many steps as cover about a
    second and every batch alike, under the profiler with the spans; then
    the host syncs of one call of the port's step (`port_call`)."""
    from port_bench import trace as T
    from port_bench.yardstick import host_syncs
    cell = record.cell
    nb = len({b for b, _ in answers})
    med = float(np.median(record.step_s))
    n = max(nb, int(np.ceil(1.0 / max(med, 1e-3) / nb)) * nb)
    entries = [tuple(e) for m in cell.per_layer
               for e in getattr(spec_mod.reader(m["name"]), "ENTRIES", ())]
    with T.Spans(TRACED_MODULES, model, entries) as spans:
        def step(j):
            b, rows, _ = one_step(i0 + j)
            record.traced_batches.append(b)
            answers.append((b, rows))
        record.timeline = T.profile_steps(step, n)
    torch.cuda.synchronize()
    record.calls = spans.calls
    record.syncs = host_syncs(port_call)
    torch.cuda.synchronize()
