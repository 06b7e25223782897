"""The JAX package's VO runner on the CPU: the ATE that `chip_smoke.py`
bounds the port's runner by.

    JAX_PLATFORMS=cpu python tools/vo_cpu_reference.py

Runs `configs/vo_synthetic.yaml` (Alike_s2d, brute force, pipelined, with
windowed BA; 8 splat frames at 512^2, top_k 1000) and the same frames
pair by pair with optical_flow (ALIKE-t, win 21, 3 levels, 40
iterations, distance 0), each with the RANSAC keys of seeds 0-4, and
prints one JSON line a run: the ATE of the chained positions against the
ground truth (Umeyama-aligned, with scale) per seed and their median,
and the seconds the run took. A single draw's ATE spreads several-fold
across seeds, so the median is what the port is held to. A CPU reference
for correctness, not a speed.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LK = {"distance": 0, "win_size": 21, "levels": 3, "interation": 40}
SEEDS = range(5)


def main() -> int:
    sys.path.insert(0, ROOT)
    from keypoint_bench_tpu.datasets.synthetic import \
        SyntheticSplatSequenceDataset
    from keypoint_bench_tpu.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu.tasks.trajectory import ate_rmse

    with open(os.path.join(ROOT, "configs", "vo_synthetic.yaml")) as f:
        base = yaml.safe_load(f)
    dp = base["data_params"]
    gt = np.stack([p[:3, 3] for p in SyntheticSplatSequenceDataset(
        dp["num_frames"], dp["image_size"], dp["seed"]).poses])
    runs = {"pipelined_ba": base,
            "sequential_lk": dict(base, model_type="Alike", task_params={},
                                  matcher_params={
                                      "type": "optical_flow",
                                      "optical_flow_params": LK})}
    for name, cfg in runs.items():
        t0 = time.perf_counter()
        ates = []
        for seed in SEEDS:
            res = Evaluator(EvalConfig(**dict(
                cfg, seed=seed, output_dir=os.path.join(
                    ROOT, "output", "vo_cpu_reference", name)))).run()
            ates.append(ate_rmse(res["t_est"][1:, :, 0], gt))
        print(json.dumps({"run": name, "ate_by_seed": ates,
                          "ate_median": statistics.median(ates),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
