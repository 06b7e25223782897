"""JAX-layout parameters -> torch-layout tensors.

The JAX package stores conv kernels as HWIO [kh, kw, in, out] and linear
weights as [in, out]; torch wants OIHW [out, in, kh, kw] and [out, in].
Vectors (biases, BatchNorm statistics) carry over unchanged.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return a.T
    return a


def params_from_jax(np_params: dict,
                    device: str | torch.device = "cpu") -> dict:
    """{name: numpy array in JAX layout} -> {name: float32 tensor in torch
    layout} on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(
                _to_torch_layout(np.asarray(v, np.float32)))).to(device)
            for k, v in np_params.items()}
