"""The readers of the program's own spans and kernel A's counter, on
synthetic chrome-trace events: idle gaps cut at nested "kbt." span
boundaries and given to the innermost span's layer (none outside every
"kbt." span), device time of the "kbt.ops." spans only, None without a
step span, an error with the step span but not the layer's."""
import pytest
import torch

from port_bench import program_spans as P
from port_bench import trace as T
from port_bench.harness import Run
from port_bench.spec import load, reader

PER = 32       # pairs a step of the cell below
LAYERS = ("step", "models", "ops", "geometry")
READERS = ("ops.device_ms_per_pair", "kernel_A.tile_passes_per_map",
           *(f"{x}.device_idle_ms_per_pair" for x in LAYERS))


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


SPANS = [("kbt.step.repeatability", 5.0, 90.0),
         ("kbt.models.forward", 10.0, 20.0),
         ("kbt.ops.detect", 40.0, 30.0),
         ("kbt.ops.detect.nms", 45.0, 15.0),
         ("port:keypoint_bench_tpu_torch.ops.cuda_nms.nms_cuda", 50.0, 8.0),
         ("kbt.geometry.ransac.solve", 75.0, 15.0)]


def _events(spans=SPANS):
    """A 100 us step span; device work at 20-25 (launched in the
    forward), 62-64 (in kernel A's entry inside kbt.ops.detect.nms) and
    92-93 (in the solve)."""
    ev = [_span(T.STEP_SPAN, 0.0, 100.0)]
    ev += [_span(*s) for s in spans]
    for corr, (t_launch, t_run, dur, name) in enumerate(
            [(12.0, 20.0, 5.0, "conv"),
             (52.0, 62.0, 2.0, "void nms_fixpoint_kernel<6>(A)"),
             (80.0, 92.0, 1.0, "svd")]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "tid": 1,
                   "ts": t_launch, "dur": 1.0, "name": "cudaLaunchKernel",
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "tid": 7, "ts": t_run,
                   "dur": dur, "name": name, "args": {"correlation": corr}})
    return ev


def _run(events):
    run = Run(load("alike_t.repeatability.b32"))
    run.timeline = T.parse_chrome_trace(events)
    run.traced_batches = [0]
    run.details = {0: {"rounds": torch.arange(2 * PER) % 5}}
    return run


def test_idle_gaps_split_at_nested_span_boundaries():
    """Gaps 0-20, 25-62, 64-92, 93-100. The step span covers 5-95, so
    0-5 and 95-100 go to no layer; the port: span inside kbt.ops.detect.nms
    changes nothing."""
    tl = _run(_events()).timeline
    idle = P.idle_by_span(tl, P.kbt_spans(tl))
    by_layer = {None: idle[None] * 1e6}
    for label, s in idle.items():
        if label is not None:
            key = P.layer_of(label)
            by_layer[key] = by_layer.get(key, 0.0) + s * 1e6
    assert by_layer == pytest.approx({None: 10.0, "step": 24.0,
                                      "models": 15.0, "ops": 28.0,
                                      "geometry": 15.0})
    assert idle["kbt.ops.detect.nms"] * 1e6 == pytest.approx(15.0)
    assert idle["kbt.ops.detect"] * 1e6 == pytest.approx(13.0)
    assert sum(idle.values()) * 1e6 == pytest.approx(
        sum(b - a for a, b in tl.gaps()))


@pytest.mark.parametrize("layer,us", [("step", 24.0), ("models", 15.0),
                                      ("ops", 28.0), ("geometry", 15.0)])
def test_idle_readers_per_pair(layer, us):
    got = reader(f"{layer}.device_idle_ms_per_pair").read(_run(_events()))
    assert got == pytest.approx(us * 1e-3 / PER)


def test_ops_device_time_counts_only_kbt_ops_launches():
    """Of the three kernels only kernel A's (2 us) was launched inside a
    kbt.ops. span; the forward's and the solve's are not counted."""
    got = reader("ops.device_ms_per_pair").read(_run(_events()))
    assert got == pytest.approx(2e-3 / PER)


def test_innermost_piece_labels():
    spans = [(0.0, 10.0, "kbt.step.auc"), (2.0, 8.0, "kbt.geometry.pose"),
             (2.0, 5.0, "kbt.geometry.ransac.solve")]
    assert P.innermost(sorted(spans, key=lambda s: (s[0], -s[1]))) == [
        (0.0, 2.0, "kbt.step.auc"), (2.0, 5.0, "kbt.geometry.ransac.solve"),
        (5.0, 8.0, "kbt.geometry.pose"), (8.0, 10.0, "kbt.step.auc")]


def test_kernel_a_counter_reader(monkeypatch, capsys):
    from keypoint_bench_tpu_torch.utils import profiling
    stats = torch.arange(PER + 62, dtype=torch.int32)
    monkeypatch.setattr(profiling, "counters", lambda: {
        "kernel_A.stats.B32.iter30": stats})
    got = reader("kernel_A.tile_passes_per_map").read(_run(_events()))
    assert got == pytest.approx(float(stats[PER:].sum()) / (2 * PER))
    assert "slots equal" in capsys.readouterr().err


def test_kernel_a_reader_raises_without_its_counter(monkeypatch):
    from keypoint_bench_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: {})
    with pytest.raises(RuntimeError, match="no kernel A counter"):
        reader("kernel_A.tile_passes_per_map").read(_run(_events()))


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_step_span(name):
    """The parent program: only the benchmark's own port: spans."""
    events = _events([s for s in SPANS if s[0].startswith("port:")])
    assert reader(name).read(_run(events)) is None


@pytest.mark.parametrize("name", [r for r in READERS
                                  if not r.startswith("step.")])
def test_readers_raise_without_their_layer_spans(name):
    events = _events([s for s in SPANS if s[0].startswith("kbt.step.")])
    with pytest.raises(RuntimeError, match="no kbt"):
        reader(name).read(_run(events))
