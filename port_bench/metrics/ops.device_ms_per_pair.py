"""ops.device_ms_per_pair: device time of the operations launched inside
the program's own "kbt.ops." spans (detection with kernel A and the
top-k, the descriptors: kernel B or the dense maps' sampling, the mutual
NN with kernel D), per pair of the traced stretch. None where the program
records no spans (port_bench/program_spans.py)."""
from port_bench import program_spans


def read(run):
    if program_spans.layer_spans(run, "ops") is None:
        return None
    return (run.timeline.device_s((f"{program_spans.PREFIX}ops.",)) * 1e3
            / program_spans.traced_pairs(run))
