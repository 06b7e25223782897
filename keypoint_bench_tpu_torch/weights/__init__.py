from keypoint_bench_tpu_torch.weights.convert import params_from_jax
from keypoint_bench_tpu_torch.weights.io import (load_golden_params, load_npz,
                                                 load_params,
                                                 stage_golden_weights)

__all__ = ["load_golden_params", "load_npz", "load_params", "params_from_jax",
           "stage_golden_weights"]
