"""models.device_ms_per_pair: device time of the operations launched
inside the model's forward methods (keypoint_bench_tpu_torch/models/),
per pair of the traced stretch."""

SPANS = ("port:keypoint_bench_tpu_torch.models.",)


def read(run):
    pairs = len(run.traced_batches) * int(run.cell.traffic["pairs_per_step"])
    return run.timeline.device_s(SPANS) * 1e3 / pairs
