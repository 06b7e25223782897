"""kernel_A.tile_passes_per_map: the 32 x 32 tiles whose local-max mask
or suppression kernel A (csrc/nms.cu) recomputed, summed over its rounds,
per map of the traced stretch (2 maps a pair). The program counts them:
while the profiler runs, `ops/cuda_nms.nms_fixpoint` hands the kernel the
accumulator "kernel_A.stats.B<B>.iter<max_iter>" (rounds per map, then
mask and suppression tiles per round), read here through
`keypoint_bench_tpu_torch.utils.profiling.counters()`. The counter's
rounds are printed on standard error against the rounds the reference's
own NMS ran on the same images. None where the program records no spans
(port_bench/program_spans.py)."""
import re
import sys

import torch

from port_bench import program_spans

NAME = re.compile(r"kernel_A\.stats\.B(\d+)\.iter(\d+)$")


def read(run):
    if program_spans.layer_spans(run, "ops") is None:
        return None
    from keypoint_bench_tpu_torch.utils import profiling
    stats = {m.group(1): t for name, t in profiling.counters().items()
             if (m := NAME.match(name))}
    per = int(run.cell.traffic["pairs_per_step"])
    if str(per) not in stats:
        raise RuntimeError(f"the trace holds the program's spans but no "
                           f"kernel A counter for {per} maps a call: "
                           f"{sorted(stats)}")
    passes = sum(int(t[int(b):].sum()) for b, t in stats.items())
    rounds = stats[str(per)][:per].long()
    ref = torch.zeros(per, dtype=torch.long)
    for b in run.traced_batches:
        r = run.details[b]["rounds"].long()
        ref += r[:per] + r[per:]
    print(f"kernel A rounds by map slot over {len(run.traced_batches)} "
          f"steps x 2 sides: counter {rounds.tolist()} (sum "
          f"{int(rounds.sum())}), reference {ref.tolist()} (sum "
          f"{int(ref.sum())}); slots equal {int((rounds == ref).sum())} "
          f"of {per}", file=sys.stderr)
    return passes / (2 * program_spans.traced_pairs(run))
