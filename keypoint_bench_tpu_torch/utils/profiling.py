"""Cost, latency and traces of a model forward (counterpart of
keypoint_bench_tpu/utils/profiling.py, which reads XLA's cost analysis
and wraps jax.profiler), and the port's own spans and counters.

`model_cost` counts the forward's floating-point operations with
`torch.utils.flop_counter.FlopCounterMode` (convolutions and matrix
products; XLA also counts elementwise operations), its bytes as the sum
of every dispatched operation's input and output tensor bytes (XLA's
"bytes accessed" counts a fused program's operands, so the two differ by
the fusion), and its parameters from the weights.

Tracing is on exactly while a torch profiler runs (`trace`, or any
`torch.profiler.profile`); there is no setting. Then `span(name)` is a
`torch.profiler.record_function`, so the port's spans (`kbt.<layer>.
<stage>`, PERF.md §3) sit on the profiler's clock beside the device's
activity and go out with its trace, and `counter` hands kernels a
persistent accumulator that `counters()` reads after the traced stretch.
With no profiler running, `span` returns one shared no-op context and
`counter` returns None. Call both through the module
(`profiling.span(...)`).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from keypoint_bench_tpu_torch.device import resolve_device

_NO_SPAN = contextlib.nullcontext()
_COUNTERS: dict[str, torch.Tensor] = {}


def span(name: str):
    """A profiler span named `name` while a torch profiler runs; else the
    shared no-op context (no allocation, no record_function)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def counter(name: str, numel: int, device) -> torch.Tensor | None:
    """While a torch profiler runs, the int32 accumulator `name` of
    `numel` entries on `device`, zeroed when first made and kept for the
    process, for a kernel to add into; else None."""
    if not torch.autograd._profiler_enabled():
        return None
    acc = _COUNTERS.get(name)
    if acc is None:
        # a normal tensor, so that counters() may zero it outside the
        # inference mode of the steps
        with torch.inference_mode(False):
            acc = _COUNTERS[name] = torch.zeros(numel, dtype=torch.int32,
                                                device=device)
    elif acc.numel() != numel or acc.device != torch.device(device):
        raise ValueError(f"counter {name} holds {acc.numel()} entries on "
                         f"{acc.device}, asked for {numel} on {device}")
    return acc


def counters() -> dict[str, torch.Tensor]:
    """{name: host copy} of every accumulator, each zeroed after the read.
    The copy waits for the device: read it after the traced stretch."""
    out = {}
    for name, acc in _COUNTERS.items():
        out[name] = acc.to("cpu", copy=True)
        acc.zero_()
    return out


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched operation's tensor inputs and
    outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_leaves((args, kwargs, out)):
            if isinstance(x, torch.Tensor):
                self.bytes += x.numel() * x.element_size()
        return out


def model_cost(model_name: str, input_shape=(1, 512, 512, 3),
               weights_dir: str | None = None,
               device: str | torch.device = "cuda") -> dict:
    """One forward of `model_name` on a float32 image of `input_shape` on
    `device`: {"model", "gflops", "bytes_accessed", "params_k"}."""
    from torch.utils.flop_counter import FlopCounterMode

    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.weights import load_params

    dev = resolve_device(device)
    params = load_params(model_name, weights_dir, dev)
    model = get_model(model_name)(params).eval()
    image = torch.zeros(tuple(input_shape), dtype=torch.float32, device=dev)
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with torch.no_grad(), flops, nbytes:
        model(image)
    return {"model": model_name,
            "gflops": flops.get_total_flops() / 1e9,
            "bytes_accessed": float(nbytes.bytes),
            "params_k": sum(v.numel() for v in params.values()) / 1e3}


def _sync(args):
    for x in tree_leaves(args):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


def measure_latency(fn, args, iters: int = 20, warmup: int = 3) -> dict:
    """Host-clock latency of fn(*args) (seconds a call, calls a second),
    waiting for the card after the warm-up and after the timed calls when
    the arguments are on it."""
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        _sync(args)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(args)
    dt = (time.perf_counter() - t0) / iters
    return {"seconds_per_iter": dt, "iters_per_second": 1.0 / dt}


def trace(fn, args, log_dir: str = "output/kbt_trace") -> str:
    """A torch.profiler trace of one call fn(*args), with the card's
    activities when an argument is on it, written as a Chrome trace to
    log_dir/trace.json. Returns the trace's path."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if any(isinstance(x, torch.Tensor) and x.is_cuda
           for x in tree_leaves(args)):
        acts.append(ProfilerActivity.CUDA)
    with torch.no_grad(), profile(activities=acts) as prof:
        fn(*args)
        _sync(args)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
