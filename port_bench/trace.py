"""The traced stretch: spans around the calls into each of the program's
layers, the profiler's device timeline, and what the metrics read of it.

Spans come from the benchmark's side. For the stretch only, `Spans`
wraps (a) the port's functions that the step's modules import from other
port modules, (b) the model's forward methods and (c) the kernels' entry
points, each in a `torch.profiler.record_function` named
"port:<defining module>.<name>"; the entry points also record CUDA events
around each call. Every device operation is then given the spans that
were open on the launching thread when it was launched (the profiler's
correlation of a kernel with its runtime call), so a metric can sum the
device time that a layer's calls launched.
"""
from __future__ import annotations

import functools
import importlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

import torch

PORT = "keypoint_bench_tpu_torch"
STEP_SPAN = "port_bench.step"


@dataclass
class KernelCalls:
    """One kernel entry point's calls in the stretch: argument shapes and
    dtypes, and the CUDA-event milliseconds of each call."""
    shapes: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def event_ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.events]


class Spans:
    """Install and remove the stretch's wrappers (see the module doc)."""

    def __init__(self, modules, model, entries):
        self.modules = [importlib.import_module(m) for m in modules]
        self.model = model
        self.entries = entries          # [(module, function name)]
        self.calls = {f"{m}.{f}": KernelCalls() for m, f in entries}
        self._undo = []

    def _patch(self, owner, name, new):
        old = getattr(owner, name)
        setattr(owner, name, new)
        self._undo.append((owner, name, old))

    def __enter__(self):
        for mod in self.modules:
            for name, obj in list(vars(mod).items()):
                src = getattr(obj, "__module__", None) or ""
                if (callable(obj) and not isinstance(obj, type)
                        and src.startswith(PORT) and src != mod.__name__):
                    self._patch(mod, name, _spanned(f"port:{src}.{name}",
                                                    obj))
        for meth in ("forward", "feats"):
            fn = getattr(self.model, meth, None)
            if fn is not None:
                cls = type(self.model)
                self._patch(self.model, meth, _spanned(
                    f"port:{cls.__module__}.{cls.__name__}.{meth}", fn))
        for m, f in self.entries:
            mod = importlib.import_module(m)
            self._patch(mod, f, _timed(f"port:{m}.{f}", getattr(mod, f),
                                       self.calls[f"{m}.{f}"]))
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._undo):
            if owner is self.model:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._undo.clear()


def _spanned(label, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def _timed(label, fn, calls: KernelCalls):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        calls.shapes.append([
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else
            [(tuple(x.shape), x.dtype) for x in a]
            if isinstance(a, (list, tuple)) else a for a in args])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(label):
            start.record()
            out = fn(*args, **kwargs)
            end.record()
        calls.events.append((start, end))
        return out
    return wrapper


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    spans: tuple          # labels of the spans open at its launch


@dataclass
class Timeline:
    """The traced window's device operations and the host's spans."""
    ops: list
    window_us: tuple      # (start, end) of the traced steps
    host: list            # [(start, end, label)] spans and CPU operations

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_s(self) -> float:
        """Union of the device operations' intervals within the window."""
        busy, end = 0.0, self.window_us[0]
        for op in sorted(self.ops, key=lambda o: o.start_us):
            a = max(op.start_us, end)
            b = min(op.start_us + op.dur_us, self.window_us[1])
            if b > a:
                busy += b - a
                end = b
        return busy / 1e6

    def gaps(self):
        """[(start_us, end_us)] of the window with no device operation."""
        out, end = [], self.window_us[0]
        for op in sorted(self.ops, key=lambda o: o.start_us):
            if op.start_us > end:
                out.append((end, min(op.start_us, self.window_us[1])))
            end = max(end, op.start_us + op.dur_us)
            if end >= self.window_us[1]:
                break
        if end < self.window_us[1]:
            out.append((end, self.window_us[1]))
        return out

    def host_at(self, t_us: float) -> str:
        """What the host was doing at t: the innermost span and the
        innermost CPU operation open on the step's thread."""
        best = {}
        for a, b, label, kind in self.host:
            if a <= t_us < b and (kind not in best
                                  or a >= best[kind][0]):
                best[kind] = (a, label)
        parts = [best[k][1] for k in ("span", "op") if k in best]
        return " / ".join(parts) or "outside the step's calls"

    def device_s(self, spans=(), name: str | None = None) -> float:
        """Seconds of device operations launched inside a span whose
        label starts with one of `spans` (any op if empty) and whose name
        matches the regular expression `name` (any if None)."""
        pat = re.compile(name) if name else None
        total = 0.0
        for op in self.ops:
            if spans and not any(s.startswith(p) for s in op.spans
                                 for p in spans):
                continue
            if pat is not None and not pat.search(op.name):
                continue
            total += op.dur_us
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        per_op, per_gap = {}, {}
        for op in self.ops:
            per_op[op.name] = per_op.get(op.name, 0.0) + op.dur_us / 1e6
        for a, b in self.gaps():
            label = self.host_at((a + b) / 2)
            per_gap[label] = per_gap.get(label, 0.0) + (b - a) / 1e6
        key = lambda kv: -kv[1]                              # noqa: E731
        return {"device_ops": [list(kv) for kv in
                               sorted(per_op.items(), key=key)[:top]],
                "idle_gaps": [list(kv) for kv in
                              sorted(per_gap.items(), key=key)[:top]]}


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def parse_chrome_trace(events: list) -> Timeline:
    """The Timeline of a torch.profiler chrome trace's events."""
    launches = {}
    spans_by_tid = {}
    host = []
    device = []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X":
            continue
        if cat in _DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], float(e["ts"]))
        elif cat == "user_annotation":
            a = float(e["ts"])
            spans_by_tid.setdefault(e["tid"], []).append(
                (a, a + float(e["dur"]), e["name"]))
        elif cat == "cpu_op":
            a = float(e["ts"])
            host.append((e["tid"], a, a + float(e["dur"]), e["name"]))
    steps = [s for ss in spans_by_tid.values() for s in ss
             if s[2] == STEP_SPAN]
    if not steps:
        raise RuntimeError("the trace holds no step span")
    window = (min(s[0] for s in steps), max(s[1] for s in steps))
    step_tid = next(t for t, ss in spans_by_tid.items()
                    if any(s[2] == STEP_SPAN for s in ss))
    host = [(a, b, name, "op") for tid, a, b, name in host
            if tid == step_tid and b > window[0] and a < window[1]]
    host += [(a, b, label, "span") for a, b, label in
             spans_by_tid[step_tid] if label != STEP_SPAN]
    ops = []
    for e in device:
        a = float(e["ts"])
        if a + float(e.get("dur", 0.0)) <= window[0] or a >= window[1]:
            continue
        tid, t = launches.get(e.get("args", {}).get("correlation"),
                              (None, None))
        open_spans = tuple(label for s0, s1, label in
                           spans_by_tid.get(tid, ()) if s0 <= t < s1) \
            if t is not None else ()
        ops.append(DeviceOp(e["name"], a, float(e.get("dur", 0.0)),
                            open_spans))
    return Timeline(ops, window, host)


def profile_steps(step, n_steps: int) -> Timeline:
    """`step(i)` for i < n_steps under torch.profiler, each in a step
    span; the trace goes through a temporary file, removed after."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):          # the profiler's own set-up
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for i in range(n_steps):
            with torch.profiler.record_function(STEP_SPAN):
                step(i)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse_chrome_trace(events)


def kernel_ms(run, entry, name: str, log=print) -> tuple[float, int]:
    """(profiler device ms, calls) of the kernels named `name` launched
    inside the entry point `entry` = (module, function) over the traced
    stretch, checked against CUDA events over the same calls: a zero or
    missing reading, or one above the events' time, raises."""
    label = f"{entry[0]}.{entry[1]}"
    calls = run.calls.get(label)
    if calls is None or not calls.events:
        return 0.0, 0
    prof = run.timeline.device_s((f"port:{label}",), name) * 1e3
    events = sum(calls.event_ms())
    log(f"kernel {label}: {len(calls.events)} calls, profiler {prof!r} ms, "
        f"CUDA events {events!r} ms")
    if not prof > 0:
        raise RuntimeError(f"the profiler reads {prof} ms for {name} in "
                           f"{len(calls.events)} calls of {label}")
    if prof > 1.05 * events + 0.005 * len(calls.events):
        raise RuntimeError(f"the profiler reads {prof} ms for {name}, more "
                           f"than the CUDA events' {events} ms")
    return prof, len(calls.events)
