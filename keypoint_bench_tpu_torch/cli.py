"""CLI entry point: `python -m keypoint_bench_tpu_torch.cli -c config.yaml test`
(counterpart of keypoint_bench_tpu/cli.py). Runs on CUDA unless
`--device cpu` is given. Under `torchrun --nproc-per-node N` it runs as N
ranks of one process group (`parallel.mesh.init_distributed`): the
batch paths (`data_params.batch_size > 1`) and `task_params.ba_distributed`
split their work over the ranks, and rank 0 writes the outputs and
prints the results."""
from __future__ import annotations

import argparse
import json
import sys

import torch.distributed as dist

from keypoint_bench_tpu_torch.parallel.mesh import init_distributed
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
    dev = init_distributed(args.device)
    try:
        ev = Evaluator(cfg, dev)
        results = ev.run()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if ev.writes:
        print(json.dumps({k: v for k, v in results.items()
                          if isinstance(v, (int, float, str))},
                         default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
