"""kernel_B_roofline: kernel B (csrc/sample.cu; entry
ops/cuda_sample.sample_cuda, ALIKE's sparse descriptors) as a share of its
roofline: the least time of its traced calls (yardstick.sample_bound:
each distinct map value a tap of non-zero weight needs, read once) over
the profiler's device time of sample_kernel in those calls. The taps come
from the reference's keypoints of the same images."""
import sys

from port_bench.trace import kernel_ms
from port_bench.yardstick import sample_bound

ENTRIES = [("keypoint_bench_tpu_torch.ops.cuda_sample", "sample_cuda")]
NAME = r"\bsample_kernel\b"


def read(run):
    ms, n = kernel_ms(run, ENTRIES[0], NAME,
                      lambda *a: print(*a, file=sys.stderr))
    if n == 0:
        return None
    per = int(run.cell.traffic["pairs_per_step"])
    calls = run.calls[".".join(ENTRIES[0])].shapes
    if n != 2 * len(run.traced_batches):
        raise RuntimeError(f"{n} calls of kernel B in "
                           f"{len(run.traced_batches)} steps, not 2 a step")
    bound = 0.0
    for j, b in enumerate(run.traced_batches):
        kpts = run.details[b]["kpts"]
        for side in (0, 1):
            feats, _, _, h, w = calls[2 * j + side][:5]
            k = kpts[side * per:(side + 1) * per].float()
            bound += sample_bound([s for s, _ in feats], feats[0][1].itemsize,
                                  k[..., 0] * (w - 1.0), k[..., 1] * (h - 1.0),
                                  h, w)[0]
    return 100.0 * bound / ms
