"""geometry.device_ms_per_pair: device time of the operations launched
inside calls of keypoint_bench_tpu_torch/geometry/ and tasks/ (warps,
repeatability, RANSAC samples and solves, pose and its error), per pair
of the traced stretch."""

SPANS = ("port:keypoint_bench_tpu_torch.geometry.",
         "port:keypoint_bench_tpu_torch.tasks.")


def read(run):
    pairs = len(run.traced_batches) * int(run.cell.traffic["pairs_per_step"])
    return run.timeline.device_s(SPANS) * 1e3 / pairs
