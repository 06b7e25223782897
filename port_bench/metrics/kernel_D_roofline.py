"""kernel_D_roofline: kernel D (csrc/match.cu; entry
ops/cuda_match.nn_dists_cuda, mutual NN) as a share of its roofline: the
least time of its traced calls (yardstick.match_bound of the shapes it was
given, [B,M,D] and [B,N,D] with the validity column) over the profiler's
device time of nn_kernel and decode_kernel in those calls."""
import math
import sys

from port_bench.trace import kernel_ms
from port_bench.yardstick import match_bound

ENTRIES = [("keypoint_bench_tpu_torch.ops.cuda_match", "nn_dists_cuda")]
NAME = r"\b(nn_kernel|decode_kernel)\b"


def read(run):
    ms, n = kernel_ms(run, ENTRIES[0], NAME,
                      lambda *a: print(*a, file=sys.stderr))
    if n == 0:
        return None
    bound = 0.0
    for call in run.calls[".".join(ENTRIES[0])].shapes:
        (sa, _), (sb, _) = call[:2]
        bound += match_bound(math.prod(sa[:-2]), sa[-2], sb[-2], sa[-1])[0]
    return 100.0 * bound / ms
