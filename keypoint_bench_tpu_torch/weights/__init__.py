from keypoint_bench_tpu_torch.weights.convert import (
    SPECS, convert_state_dict, params_from_jax, to_numpy_layout,
    to_torch_layout)
from keypoint_bench_tpu_torch.weights.io import (
    WEIGHTS_DIR, lightglue_input_proj_params, load_golden_params, load_npz,
    load_params, save_params, stage_golden_weights)

__all__ = ["SPECS", "WEIGHTS_DIR", "convert_state_dict",
           "lightglue_input_proj_params", "load_golden_params", "load_npz",
           "load_params", "params_from_jax", "save_params",
           "stage_golden_weights", "to_numpy_layout", "to_torch_layout"]
