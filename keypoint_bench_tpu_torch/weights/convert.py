"""JAX-layout parameters -> torch-layout tensors.

The JAX package stores conv kernels as HWIO [kh, kw, in, out] and linear
weights as [in, out]; torch wants OIHW [out, in, kh, kw] and [out, in].
Vectors (biases, BatchNorm statistics) carry over unchanged. bf16 arrays
(the JAX package's `cast_params_bf16` output, whose numpy dtype is
ml_dtypes' "bfloat16") stay bf16; everything else becomes float32.
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


def _tensor(v, device) -> torch.Tensor:
    a = np.asarray(v)
    # numpy has no bf16 of its own: go through f32, which holds it exactly
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    t = torch.from_numpy(np.ascontiguousarray(
        _to_torch_layout(a.astype(np.float32))))
    return t.to(device, dtype)


def params_from_jax(np_params: dict,
                    device: str | torch.device = "cpu") -> dict:
    """{name: array in JAX layout} -> {name: tensor in torch layout} on
    `device`: float32, or bf16 for a bf16 array."""
    return {k: _tensor(v, device) for k, v in np_params.items()}
