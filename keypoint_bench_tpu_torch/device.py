"""Device resolution for the port's entry points.

Entry points take `device=` and default to CUDA. Without CUDA they raise
unless the caller asked for the CPU explicitly: the port never drops to
the CPU on its own.

Float32 parity: cuDNN convolutions default to TF32 on Hopper (about three
decimal digits), which would break parity with the JAX reference's
HIGHEST-precision f32 convs. Importing this module turns TF32 off for
both convolutions and matmuls.

bf16 parity: cuBLAS may reduce a bf16 matrix product in bf16 (split-K
partial sums) unless told not to; XLA accumulates bf16 products in f32,
so importing this module also turns that reduced-precision reduction off.
"""
from __future__ import annotations

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """`device` as a torch.device; raises if CUDA is asked for (the
    default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
