"""The program's own spans in the traced stretch.

While a torch profiler runs, the port records spans named
"kbt.<layer>.<stage>" (`keypoint_bench_tpu_torch/utils/profiling.span`;
the list is PERF.md §3's), with "kbt.step.<task>" around each batched
step. `trace.parse_chrome_trace` keeps them among the step thread's host
spans, and every device operation keeps the spans open at its launch. The
readers here take the card's idle time (`Timeline.gaps()`), cut at the
boundaries of those spans, and give each piece to the layer of the
innermost "kbt." span open on the step's thread over it; idle time with
no "kbt." span open (the harness's upload and copy, between steps) goes
to no layer.

A reader returns None where the trace holds no "kbt.step." span (a
program without spans of its own) and raises where the step span is
there but its layer's spans are not.
"""
from __future__ import annotations

PREFIX = "kbt."
STEP = "kbt.step."


def layer_of(label: str) -> str:
    """"kbt.ops.detect.nms" -> "ops"."""
    return label.split(".")[1]


def kbt_spans(timeline) -> list:
    """[(start_us, end_us, label)] of the step thread's "kbt." spans, by
    start (the enclosing span first on equal starts)."""
    return sorted(((a, b, label) for a, b, label, kind in timeline.host
                   if kind == "span" and label.startswith(PREFIX)),
                  key=lambda s: (s[0], -s[1]))


def layer_spans(run, layer: str) -> list | None:
    """The run's "kbt." spans; None without a step span; raises if the
    step span is there and `layer` has none."""
    spans = kbt_spans(run.timeline)
    if not any(label.startswith(STEP) for _, _, label in spans):
        return None
    if not any(layer_of(label) == layer for _, _, label in spans):
        raise RuntimeError(f"the trace holds the program's step spans but "
                           f"no kbt.{layer}. span")
    return spans


def traced_pairs(run) -> int:
    return len(run.traced_batches) * int(run.cell.traffic["pairs_per_step"])


def innermost(spans) -> list:
    """[(t0, t1, label)]: the stretches between consecutive boundaries of
    `spans` (kbt_spans' order), each with the innermost span open over it
    (the latest started), label None where none is."""
    bounds = sorted({t for a, b, _ in spans for t in (a, b)})
    pieces, open_, i = [], [], 0
    for t0, t1 in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][0] <= t0:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s[1] > t0]
        inner = max(open_, key=lambda s: (s[0], -s[1]), default=None)
        pieces.append((t0, t1, inner[2] if inner else None))
    return pieces


def idle_by_span(timeline, spans) -> dict:
    """{label or None: seconds} of the stretch's device-idle time, each
    piece given to the innermost of `spans` open over it."""
    pieces = innermost(spans)
    out = {None: 0.0}
    j = 0
    for g0, g1 in timeline.gaps():
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        held = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b = max(pieces[k][0], g0), min(pieces[k][1], g1)
            if b > a:
                label = pieces[k][2]
                out[label] = out.get(label, 0.0) + b - a
                held += b - a
            k += 1
        out[None] += (g1 - g0) - held
    return {label: us / 1e6 for label, us in out.items()}


def idle_ms_per_pair(run, layer: str):
    """The idle milliseconds a traced pair that `layer`'s spans held."""
    spans = layer_spans(run, layer)
    if spans is None:
        return None
    idle = idle_by_span(run.timeline, spans)
    held = sum(s for label, s in idle.items()
               if label is not None and layer_of(label) == layer)
    return held * 1e3 / traced_pairs(run)
