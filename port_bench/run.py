"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

prints one JSON result as the last line of standard output (the end-to-end
metrics with --trace 0, the per-layer ones with --trace 1) and, last on
standard error, every number compared with the reference beside its
limit. `--control tf32|bf16` computes the cell's answers in a lower
precision instead of measuring (the reference with TF32 convolutions and
matmuls, or the port's bfloat16 weights) and judges them alike: the check
must call those not correct. Exit codes: 0 with a result, 3 without the
cards the cell needs, 1 on any other failure.
"""
import time

T0 = time.perf_counter()   # set-up counts from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "bf16"))
    args = ap.parse_args(argv)
    # build and kernel caches stay inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".port_bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    from port_bench import harness
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T0, control=args.control)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)       # "checks" is its last key
    return 0


if __name__ == "__main__":
    sys.exit(main())
