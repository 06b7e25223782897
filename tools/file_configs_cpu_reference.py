"""The JAX package's runners on the CPU on the file-backed trees that
`chip_smoke.py` writes: the values it holds the port's runs against.

    JAX_PLATFORMS=cpu python tools/file_configs_cpu_reference.py

Writes chip_smoke's HPatches tree (3 sequences of 6 PPMs at 800 x 600 and
1000 x 700) and KITTI tree (8 gray PNG frames at 376 x 1241) under
output/file_configs_cpu_reference, runs configs/repeatability_hpatches.yaml,
configs/mha_hpatches.yaml and configs/vo_kitti.yaml on them (the KITTI run
with the RANSAC / LK keys of seeds 0-4), and prints one JSON line a run:
repeatability, MHA@3, the KITTI ATE per seed and its median, and the
seconds each took. These go into `chip_smoke.JAX_CPU_FILE`. A CPU
reference for correctness, not a speed.
"""
from __future__ import annotations

import json
import os
import runpy
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(5)


def main() -> int:
    sys.path.insert(0, ROOT)
    from keypoint_bench_tpu.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu.tasks.trajectory import ate_rmse

    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                           run_name="file_configs_cpu_reference")
    out = os.path.join(ROOT, "output", "file_configs_cpu_reference")
    hp = smoke["hpatches_tree"](os.path.join(out, "hpatches"))
    for name, metric in (("repeatability_hpatches", "repeatability"),
                         ("mha_hpatches", "MHA@3")):
        t0 = time.perf_counter()
        res = Evaluator(EvalConfig(**smoke["file_config"](
            name, os.path.join(out, name), root=hp))).run()
        print(json.dumps({"run": name, metric: res[metric],
                          "seconds": time.perf_counter() - t0}), flush=True)
    seq, gt_path = smoke["kitti_tree"](os.path.join(out, "kitti"))
    gt = np.stack([[float(v) for v in ln.split()][3::4]
                   for ln in open(gt_path) if ln.strip()])
    t0 = time.perf_counter()
    ates = []
    for seed in SEEDS:
        cfg = dict(smoke["file_config"]("vo_kitti", os.path.join(
            out, f"vo_kitti_{seed}"), root=seq, gt=gt_path), seed=seed)
        res = Evaluator(EvalConfig(**cfg)).run()
        ates.append(ate_rmse(res["t_est"][1:, :, 0], gt))
    print(json.dumps({"run": "vo_kitti", "ate_by_seed": ates,
                      "kitti_ate": statistics.median(ates),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
