"""geometry.device_idle_ms_per_pair: the card's idle time in the traced
stretch while the innermost of the program's spans open on the step's
thread was a "kbt.geometry." span (warps, repeatability, RANSAC samples,
solves, scores and refits, the pose and recoverPose, the pose error),
per pair of the traced stretch (port_bench/program_spans.py)."""
from port_bench import program_spans


def read(run):
    return program_spans.idle_ms_per_pair(run, "geometry")
