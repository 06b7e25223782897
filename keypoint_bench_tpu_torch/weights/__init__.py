from keypoint_bench_tpu_torch.weights.convert import params_from_jax
from keypoint_bench_tpu_torch.weights.io import load_npz, load_params

__all__ = ["load_npz", "load_params", "params_from_jax"]
