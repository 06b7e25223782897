"""Weight loading: the JAX package's converted `.npz` files, read with numpy.

`weights_npz/<name>.npz` holds the torch parameter names with conv kernels
in HWIO and linears in [in, out] (the JAX layout); `params_from_jax`
(weights/convert.py) turns them back into torch's OIHW / [out, in].
"""
from __future__ import annotations

import os

import numpy as np
import torch

from keypoint_bench_tpu_torch.weights.convert import params_from_jax

WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "weights_npz")

# Alike_s2d is a TPU layout variant of the same checkpoint and forward
_ALIASES = {"Alike_s2d": "Alike"}


def load_npz(name: str, weights_dir: str | None = None) -> dict:
    """The JAX-layout numpy parameters of model `name`."""
    name = _ALIASES.get(name, name)
    path = os.path.join(weights_dir or WEIGHTS_DIR, f"{name}.npz")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_params(name: str, weights_dir: str | None = None,
                device: str | torch.device = "cpu") -> dict:
    """Torch-layout parameters of model `name` as float32 tensors."""
    return params_from_jax(load_npz(name, weights_dir), device)
