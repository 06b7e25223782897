"""The traced stretch's reduction: the chrome trace to a timeline, the
busy share and gaps, layer sums by span, and the kernel cross-check that
refuses a zero reading."""
import pytest

from port_bench import trace as T
from port_bench.harness import Run
from port_bench.spec import load


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": T.STEP_SPAN,
           "tid": 1, "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "tid": 1, "ts": 10.0,
           "dur": 30.0, "name": "port:keypoint_bench_tpu_torch.models.x.f"},
          {"ph": "X", "cat": "user_annotation", "tid": 1, "ts": 50.0,
           "dur": 20.0,
           "name": "port:keypoint_bench_tpu_torch.ops.cuda_nms.nms_cuda"},
          {"ph": "X", "cat": "cpu_op", "tid": 1, "ts": 80.0, "dur": 15.0,
           "name": "aten::item"}]
    for corr, (t_launch, t_run, dur, name) in enumerate(
            [(12.0, 20.0, 10.0, "conv"), (55.0, 60.0, 15.0,
                                          "void nms_fixpoint_kernel<6>(A)"),
             (90.0, 96.0, 2.0, "copy")]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "tid": 1,
                   "ts": t_launch, "dur": 1.0, "name": "cudaLaunchKernel",
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "tid": 7, "ts": t_run,
                   "dur": dur, "name": name, "args": {"correlation": corr}})
    return ev


def test_timeline_busy_gaps_and_spans():
    tl = T.parse_chrome_trace(_events())
    assert tl.window_s == pytest.approx(100e-6)
    assert tl.busy_s() == pytest.approx(27e-6)
    assert tl.gaps() == [(0.0, 20.0), (30.0, 60.0), (75.0, 96.0),
                         (98.0, 100.0)]
    assert tl.device_s(("port:keypoint_bench_tpu_torch.models.",)) == \
        pytest.approx(10e-6)
    assert tl.device_s((), r"\bnms_fixpoint_kernel\b") == pytest.approx(
        15e-6)
    bd = tl.breakdown()
    assert bd["device_ops"][0] == ["void nms_fixpoint_kernel<6>(A)",
                                   pytest.approx(15e-6)]
    labels = dict((k, v) for k, v in bd["idle_gaps"])
    assert labels["aten::item"] == pytest.approx(21e-6)


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _run(kernel_dur_us):
    ev = _events()
    ev[-3]["dur"] = kernel_dur_us
    run = Run(load("alike_t.repeatability.b32"))
    run.timeline = T.parse_chrome_trace(ev)
    calls = T.KernelCalls()
    calls.events.append((_Event(0.0), _Event(0.02)))
    run.calls = {"keypoint_bench_tpu_torch.ops.cuda_nms.nms_cuda": calls}
    return run


ENTRY = ("keypoint_bench_tpu_torch.ops.cuda_nms", "nms_cuda")


def test_kernel_time_checked_against_events():
    ms, n = T.kernel_ms(_run(15.0), ENTRY, r"\bnms_fixpoint_kernel\b",
                        log=lambda *a: None)
    assert (ms, n) == (pytest.approx(0.015), 1)


def test_kernel_time_refuses_a_zero_reading():
    with pytest.raises(RuntimeError, match="reads 0"):
        T.kernel_ms(_run(0.0), ENTRY, r"\bnms_fixpoint_kernel\b",
                    log=lambda *a: None)


def test_kernel_time_refuses_more_than_the_events():
    with pytest.raises(RuntimeError, match="more than"):
        T.kernel_ms(_run(40.0), ENTRY, r"\bnms_fixpoint_kernel\b",
                    log=lambda *a: None)
