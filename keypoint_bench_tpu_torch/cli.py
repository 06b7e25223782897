"""CLI entry point: `python -m keypoint_bench_tpu_torch.cli -c config.yaml test`
(counterpart of keypoint_bench_tpu/cli.py). Runs on CUDA unless
`--device cpu` is given."""
from __future__ import annotations

import argparse
import json
import sys

from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator


def main(argv=None):
    ap = argparse.ArgumentParser(prog="keypoint_bench_tpu_torch")
    ap.add_argument("-c", "--config", required=True, help="YAML config path")
    ap.add_argument("command", nargs="?", default="test", choices=["test"],
                    help="subcommand (test)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    cfg = EvalConfig.from_yaml(args.config)
    results = Evaluator(cfg, args.device).run()
    print(json.dumps({k: v for k, v in results.items()
                      if isinstance(v, (int, float, str))}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
