"""pairs_per_s: the pairs of every step of the window over the window's
seconds (host clock, from the first upload to the last step's outputs on
the host)."""
from port_bench.yardstick import rate


def read(run):
    return rate(run.pairs, run.window_s)
