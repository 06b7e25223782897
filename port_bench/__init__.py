"""The benchmark of the PyTorch / H100 port (`keypoint_bench_tpu_torch`).

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json. Each configuration, traffic
mix, cell's limits and metric has a file of its own here (`configs/`,
`traffic/`, `limits/`, `metrics/`), found by the names in BENCHMARK.json;
`reference/` is the plain reference that decides `correct`. Nothing here
imports jax or the JAX package, and the reference imports nothing of the
port.
"""
