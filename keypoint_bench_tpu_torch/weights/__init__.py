from keypoint_bench_tpu_torch.weights.convert import params_from_jax
from keypoint_bench_tpu_torch.weights.io import (
    lightglue_input_proj_params, load_golden_params, load_npz, load_params,
    stage_golden_weights)

__all__ = ["lightglue_input_proj_params", "load_golden_params", "load_npz",
           "load_params", "params_from_jax", "stage_golden_weights"]
