from keypoint_bench_tpu_torch.datasets.registry import get_dataset

__all__ = ["get_dataset"]
