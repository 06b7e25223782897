"""The JAX package's sweep on the CPU: the repeatability that
`chip_smoke.py` prints beside the port's sweep on the card.

    JAX_PLATFORMS=cpu python tools/sweep_cpu_reference.py

Runs the JAX `run_sweep` on `configs/sweep_repeatability.yaml`'s base
(synthetic homography pairs, 4 at 512^2, NMS 6, top_k 1000) over its
seven models, then over DISK, sfd2 and D2Net from their golden
randomized weights (staged into output/sweep_cpu_reference/weights) and
ORB and SIFT, and prints one JSON line: each model's repeatability,
rep_mean_err and num_feat, and the seconds the runs took. A CPU
reference for correctness, not a speed.
"""
from __future__ import annotations

import json
import os
import sys
import time

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_MODELS = ["DISK", "sfd2", "D2Net"]
CLASSIC_MODELS = ["ORB", "SIFT"]


def main() -> int:
    sys.path.insert(0, ROOT)
    from keypoint_bench_tpu.sweep import run_sweep
    from keypoint_bench_tpu_torch.weights import stage_golden_weights

    with open(os.path.join(ROOT, "configs", "sweep_repeatability.yaml")) as f:
        spec = yaml.safe_load(f)
    out = os.path.join(ROOT, "output", "sweep_cpu_reference")
    base = dict(spec["base"], output_dir=out)
    t0 = time.perf_counter()
    res = run_sweep(base, spec["models"])
    staged = dict(base, weights_dir=stage_golden_weights(
        os.path.join(out, "weights")))
    res.update(run_sweep(staged, GOLDEN_MODELS + CLASSIC_MODELS))
    print(json.dumps({"sweep": {m: {k: r.get(k) for k in (
        "repeatability", "rep_mean_err", "num_feat")} for m, r in res.items()},
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
