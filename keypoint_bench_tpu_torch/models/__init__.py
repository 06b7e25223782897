from keypoint_bench_tpu_torch.models.registry import (PARAM_MODELS,
                                                     get_model, list_models,
                                                     register)

__all__ = ["PARAM_MODELS", "get_model", "list_models", "register"]
