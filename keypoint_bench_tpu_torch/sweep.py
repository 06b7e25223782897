"""In-process model / sequence sweeps (counterpart of
keypoint_bench_tpu/sweep.py): one Evaluator config per model (and per
sequence), in one process.

    python -m keypoint_bench_tpu_torch.sweep -c <yaml>
    python -m keypoint_bench_tpu_torch.sweep -c <yaml> --device cpu

e.g. <yaml> = configs/sweep_repeatability.yaml.

The YAML holds `base` (an EvalConfig dict), `models` and optionally
`sequences` (dicts merged into base's data_params). Runs on CUDA unless
`--device cpu` is given. A model whose weights file is missing gets
{"error": ...} in place of its results, as in the JAX sweep.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys

import torch


def run_sweep(base_config: dict, models=None, sequences=None,
              device: str | torch.device = "cuda") -> dict:
    """{model or model/sequence: the scalar results of its run}."""
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator

    models = models or [base_config["model_type"]]
    sequences = sequences or [None]
    all_results = {}
    for model in models:
        for seq in sequences:
            cfg = copy.deepcopy(base_config)
            cfg["model_type"] = model
            key = model
            if seq is not None:
                cfg["data_params"].update(seq)
                key = f"{model}/{seq.get('name', seq)}"
            cfg["output_dir"] = f"{cfg.get('output_dir', 'output')}/{key}"
            print(f"=== sweep: {key} ===", flush=True)
            try:
                res = Evaluator(EvalConfig.from_dict(cfg), device).run()
            except FileNotFoundError as e:
                all_results[key] = {"error": str(e)}
                continue
            all_results[key] = {k: v for k, v in res.items()
                                if isinstance(v, (int, float, str))}
    return all_results


def main(argv=None):
    import yaml
    ap = argparse.ArgumentParser(prog="keypoint_bench_tpu_torch.sweep")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        spec = yaml.safe_load(f)
    results = run_sweep(spec["base"], spec.get("models"),
                        spec.get("sequences"), args.device)
    print(json.dumps(results, indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
