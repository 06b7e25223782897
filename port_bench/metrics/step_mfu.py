"""step_mfu: the whole step's share of the card's float32 peak (67
TFLOP/s): the FLOPs a pair needs over the window's wall time (the
unprofiled window of the same run).

A pair's FLOPs are counted once: the plain reference's forward of one
image by torch's FlopCounterMode (convolutions and matrix products) on
the meta device, twice; where the port legitimately computes less, what
the outputs need (ALIKE's sparse path: the descriptor head at the K
keypoints, not over the dense map); and kernel D's 2 K K D products."""
from torch.utils.flop_counter import FlopCounterMode

import torch

from port_bench.reference.models import FORWARDS, load_weights
from port_bench.spec import ROOT
from port_bench.yardstick import PEAK_F32


def pair_flops(config: dict, size: int) -> float:
    weights = load_weights(f"{ROOT}/{config['weights']}", "meta", meta=True)
    x = torch.empty((1, 3, size, size), device="meta")
    with FlopCounterMode(display=False) as fc:
        _, desc = FORWARDS[config["model"]](weights, x)
    image = float(fc.get_total_flops())
    d = desc.shape[1]
    k = int(config["extractor"]["top_k"])
    if config["sparse_desc"]:
        image += 2.0 * d * d * (k - size * size)
    return 2.0 * image + 2.0 * k * k * d


def read(run):
    flops = pair_flops(run.cell.config, int(run.cell.traffic["image_size"]))
    return 100.0 * flops * run.pairs / run.window_s / PEAK_F32
