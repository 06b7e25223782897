"""kernel_A_roofline: kernel A (csrc/nms.cu; entry ops/cuda_nms.nms_cuda)
as a share of its roofline: the least time of its traced calls
(yardstick.nms_bound of each call's maps, the larger of bytes and
operations) over the profiler's device time of nms_fixpoint_kernel in
those calls. A call's rounds are the ones the reference's own plain NMS
ran on its score maps of the same images; nothing is read from the
port."""
import sys

from port_bench.trace import kernel_ms
from port_bench.yardstick import nms_bound

ENTRIES = [("keypoint_bench_tpu_torch.ops.cuda_nms", "nms_cuda")]
NAME = r"\bnms_fixpoint_kernel\b"


def read(run):
    ms, n = kernel_ms(run, ENTRIES[0], NAME,
                      lambda *a: print(*a, file=sys.stderr))
    if n == 0:
        return None
    per = int(run.cell.traffic["pairs_per_step"])
    calls = run.calls[".".join(ENTRIES[0])].shapes
    if n != 2 * len(run.traced_batches):
        raise RuntimeError(f"{n} calls of kernel A in "
                           f"{len(run.traced_batches)} steps, not 2 a step")
    bound = 0.0
    for j, b in enumerate(run.traced_batches):
        rounds = run.details[b]["rounds"]
        for side in (0, 1):
            (bsz, h, w), _ = calls[2 * j + side][0]
            r = rounds[side * per:(side + 1) * per]
            bound += nms_bound(bsz, h, w, int(r.sum()))[0]
    return 100.0 * bound / ms
