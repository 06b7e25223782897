from keypoint_bench_tpu_torch.models.registry import get_model, register

__all__ = ["get_model", "register"]
