"""Export, profiling and the info CLI on the CPU (mirrors the export and
cost cases of tests/test_utils.py).

- Export: LETNet and ALIKE-t at 64^2 through `export_model` and
  `load_exported` (.pt2): outputs bit-equal to the eager forward.
- `model_cost` against the JAX package's (XLA's cost analysis): params_k
  equal, gflops within 5% (XLA also counts elementwise operations). The
  port counts bytes as every dispatched operation's input and output
  bytes, XLA its fused program's; their ratio is measured, written
  below, and gated within 1%.
- `info --device cpu` prints one JSON object with the JAX CLI's keys.
(tests/test_torch_isolation.py holds `export_model`, `model_cost` and
`info` to refusing a host without CUDA unless asked for the CPU.)
"""
import json
import os

import numpy as np
import pytest
import torch

from keypoint_bench_tpu.utils.profiling import model_cost as jax_model_cost
from keypoint_bench_tpu_torch import info
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.utils.export import export_model, load_exported
from keypoint_bench_tpu_torch.utils.profiling import (measure_latency,
                                                      model_cost, trace)
from keypoint_bench_tpu_torch.weights import load_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a test, which torch's intra-op threads slow down
    where the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE = (1, 64, 64, 3)
# port bytes / XLA bytes at 64^2, measured with torch 2.13.0 and jax 0.9.0
BYTES_RATIO = {"Alike": 26485536.0 / 10873404.0,
               "LETNet": 4969824.0 / 2347120.0}


@pytest.mark.parametrize("name", ["LETNet", "Alike"])
def test_export_roundtrip(tmp_path, name):
    path = export_model(name, str(tmp_path / f"{name}.pt2"), SHAPE,
                        device="cpu")
    assert os.path.getsize(path) > 1000
    call = load_exported(path)
    img = torch.from_numpy(
        np.random.default_rng(0).random(SHAPE, np.float32))
    model = get_model(name)(load_params(name)).eval()
    with torch.no_grad():
        want = model(img)
    got = call(img)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["LETNet", "Alike"])
def test_model_cost_matches_jax(name):
    got = model_cost(name, SHAPE, device="cpu")
    want = jax_model_cost(name, SHAPE)
    assert got["model"] == name
    assert got["params_k"] == want["params_k"]
    assert abs(got["gflops"] / want["gflops"] - 1.0) < 0.05
    ratio = got["bytes_accessed"] / want["bytes_accessed"]
    assert abs(ratio / BYTES_RATIO[name] - 1.0) < 0.01, ratio


def test_latency_and_trace(tmp_path):
    model = get_model("LETNet")(load_params("LETNet")).eval()
    img = torch.zeros(SHAPE)
    lat = measure_latency(model, (img,), iters=2, warmup=1)
    assert lat["seconds_per_iter"] > 0
    assert lat["iters_per_second"] == pytest.approx(
        1.0 / lat["seconds_per_iter"])
    path = trace(model, (img,), str(tmp_path / "trace"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_info_cli_prints_one_json(capsys):
    info.main(["LETNet", "--size", "64", "--latency", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert {"model", "gflops", "bytes_accessed", "params_k",
            "seconds_per_iter", "iters_per_second"} <= set(out)
    assert out["device"] == "cpu" and out["params_k"] == 1.048
