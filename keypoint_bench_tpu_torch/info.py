"""Model info CLI (counterpart of keypoint_bench_tpu/info.py):

    python -m keypoint_bench_tpu_torch.info Alike [--size 512] [--latency]
                                            [--device cuda|cpu]

prints one JSON object: the JAX CLI's keys (model, gflops,
bytes_accessed, params_k; with --latency seconds_per_iter and
iters_per_second of the forward on a random image), plus the device and,
on the card, its name and power limit. It runs on the card unless asked
for the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from keypoint_bench_tpu_torch.device import resolve_device


def card_power_limit() -> str | None:
    """The card's power limit as nvidia-smi reports it, or None where
    nvidia-smi cannot be run."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if res.returncode == 0 and lines else None


def info(model: str, size: int = 512, latency: bool = False,
         device: str | torch.device = "cuda") -> dict:
    from keypoint_bench_tpu_torch.utils.profiling import (measure_latency,
                                                          model_cost)
    dev = resolve_device(device)
    out = model_cost(model, (1, size, size, 3), device=dev)
    if latency:
        from keypoint_bench_tpu_torch.models import get_model
        from keypoint_bench_tpu_torch.weights import load_params
        fwd = get_model(model)(load_params(model, device=dev)).eval()
        img = torch.as_tensor(np.random.default_rng(0).random(
            (1, size, size, 3), np.float32), device=dev)
        out.update(measure_latency(fwd, (img,)))
    out["device"] = str(dev)
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
        out["power_limit"] = card_power_limit()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="keypoint_bench_tpu_torch.info")
    ap.add_argument("model")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--latency", action="store_true",
                    help="also measure the forward's latency")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "path)")
    args = ap.parse_args(argv)
    print(json.dumps(info(args.model, args.size, args.latency,
                          args.device), indent=2))


if __name__ == "__main__":
    main()
