"""step_ms_p95: the 95th percentile of every step time of the window
(host clock, upload to outputs on the host), in ms."""
from port_bench.yardstick import p95


def read(run):
    return p95(run.step_s) * 1e3
