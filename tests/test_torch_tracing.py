"""The port's own spans and counters (`utils/profiling.py`) on the CPU.

With no profiler running, `profiling.span` is one shared no-op context and
never reaches `record_function`. Under `torch.profiler` (CPU activity
only), the batched repeatability step (ALIKE's sparse path and the dense
path) and the batched AUC step record exactly the spans PERF.md §3 lists
for them, each inside its documented parent, and give the same outputs
bit for bit as without the profiler. Kernel A's counter exists on the
card only, so `profiling.counters()` stays empty here.
"""
import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.parallel import evaluate as tev
from keypoint_bench_tpu_torch.utils import profiling
from keypoint_bench_tpu_torch.weights import load_params

B, S = 4, 64
DP = DetectParams(nms_dist=4, border_dist=4, top_k=64, max_nms_iter=8)
STEP_R, STEP_A = "kbt.step.repeatability", "kbt.step.auc"
POSE = "kbt.geometry.pose"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def alike():
    return get_model("Alike")(load_params("Alike"))


def warped_pairs(n=B, s=S):
    """Textured pairs one pixel apart (tests/test_torch_parallel.py's)."""
    rng = np.random.default_rng(0)
    imgs0 = rng.random((n, s, s, 3), np.float32)
    imgs1 = np.roll(imgs0, 1, axis=2)
    H = np.eye(3, dtype=np.float32)
    H[0, 2] = 1.0
    Hs = np.tile(H[None], (n, 1, 1))
    Hinvs = np.tile(np.linalg.inv(H).astype(np.float32)[None], (n, 1, 1))
    return (imgs0, imgs1, Hs, Hinvs, np.full((n, 2), float(s)),
            np.full((n,), float(s)), list(range(n)))


def se3_pairs(n=2, s=128):
    ds = get_dataset({"type": "synthetic_se3", "num_pairs": n,
                      "image_size": s})
    items = [ds[i] for i in range(n)]
    return [np.stack([np.asarray(f(x), np.float32) for x in items]) for f in (
        lambda x: x["image0"], lambda x: x["image1"],
        lambda x: x["warp01_params"]["intrinsics0"],
        lambda x: x["warp01_params"]["intrinsics1"],
        lambda x: x["warp01_params"]["pose01"])] + [list(range(n))]


def _head(step, sparse=True):
    """The spans of forward_detect on both image sets (pairs of name,
    parent); sparse ALIKE describes here, the dense path in the match."""
    one = [("kbt.models.forward", step), ("kbt.ops.detect", step),
           ("kbt.ops.detect.nms", "kbt.ops.detect"),
           ("kbt.ops.detect.topk", "kbt.ops.detect")]
    if sparse:
        one.append(("kbt.ops.describe", step))
    return 2 * one


def _ransac(parent):
    return [(f"kbt.geometry.ransac.{s}", parent)
            for s in ("solve", "score", "refit")]


def expected_repeatability(sparse: bool):
    spans = [(STEP_R, None), *_head(STEP_R, sparse),
             ("kbt.geometry.warp", STEP_R),
             ("kbt.geometry.repeatability", STEP_R),
             ("kbt.ops.match", STEP_R),
             ("kbt.geometry.ransac.samples", STEP_R), *_ransac(STEP_R)]
    if not sparse:
        spans.append(("kbt.ops.describe", "kbt.ops.match"))
    return collections.Counter(spans)


def expected_auc():
    return collections.Counter([
        (STEP_A, None), *_head(STEP_A), ("kbt.ops.match", STEP_A),
        ("kbt.geometry.ransac.samples", STEP_A), (POSE, STEP_A),
        *_ransac(POSE), ("kbt.geometry.pose.recover", POSE),
        ("kbt.geometry.pose_error", STEP_A)])


def traced(fn, tmp_path):
    """(fn()'s outputs under the profiler, Counter of (span, parent) of
    the trace's user annotations: the parent is the shortest span on the
    same thread that encloses it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    found = collections.Counter()
    for e in events:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        around = [p for p in events if p is not e and p["tid"] == e["tid"]
                  and float(p["ts"]) <= a
                  and b <= float(p["ts"]) + float(p["dur"])]
        parent = min(around, key=lambda p: float(p["dur"]))["name"] \
            if around else None
        found[(e["name"], parent)] += 1
    return out, found


def assert_bit_equal(got, want):
    got = got.values() if isinstance(got, dict) else got
    want = want.values() if isinstance(want, dict) else want
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_span_without_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("kbt.step.repeatability")
    assert first is profiling.span("kbt.ops.detect")
    with first:
        with profiling.span("kbt.ops.detect.nms"):
            pass
    assert profiling.counter("kernel_A.stats.B4.iter8", 22, "cpu") is None


def test_span_under_profiler_is_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("kbt.ops.match"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_repeatability_step_spans(alike, sparse, tmp_path):
    batch = warped_pairs()

    def step():
        return tev.batched_repeatability_step(alike, DP, *batch,
                                              sparse=sparse, device="cpu")

    want = step()
    got, spans = traced(step, tmp_path)
    assert spans == expected_repeatability(sparse)
    assert_bit_equal(got, want)
    assert float(got["repeatability"].mean()) > 0.1
    assert profiling.counters() == {}


def test_auc_step_spans(alike, tmp_path):
    batch = se3_pairs()

    def step():
        return tev.batched_auc_step(alike, DP, *batch, n_hyp=64,
                                    sparse=True, device="cpu")

    want = step()
    got, spans = traced(step, tmp_path)
    assert spans == expected_auc()
    assert_bit_equal(got, want)
    assert profiling.counters() == {}


def test_counter_made_in_a_step_is_read_and_zeroed_after(monkeypatch):
    """A counter first made inside a step's inference mode is an ordinary
    tensor: added into there, read and zeroed by counters() outside."""
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.inference_mode():
            acc = profiling.counter("kernel_A.stats.B2.iter1", 6, "cpu")
            acc += torch.arange(6, dtype=torch.int32)
        assert profiling.counter("kernel_A.stats.B2.iter1", 6, "cpu") is acc
        with pytest.raises(ValueError, match="holds 6 entries"):
            profiling.counter("kernel_A.stats.B2.iter1", 7, "cpu")
    got = profiling.counters()
    assert torch.equal(got["kernel_A.stats.B2.iter1"],
                       torch.arange(6, dtype=torch.int32))
    assert int(acc.sum()) == 0
