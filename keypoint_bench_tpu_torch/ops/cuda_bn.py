"""The eval BatchNorm epilogue on CUDA (csrc/bn_epilogue.cu): the conv's
bias where it has one, normalise, then an optional residual add and an
optional ReLU, in one pass over the map.

It replaces no TPU kernel: XLA fused this epilogue into the convolution.
Its plain twin is models/common.py `bn_chain`, which `bn_eval` takes for
CPU tensors; for a CUDA tensor `bn_eval` calls `bn_epilogue`, which
launches the kernel or raises. The kernel gives the chain's bits.

`bn_epilogue` calls the operator `kbt::bn_epilogue`, so that
`torch.export` and `torch.compile` record the kernel as one node (its
fake implementation gives the output's shape and dtype) and an exported
program launches it. The operator is defined with `torch.library.Library`,
which adds nothing to a call's path; `torch.library.custom_op` would wrap
the launch in a dynamo guard that imports torch._dynamo at the first call
(seconds of a process's set-up). The kernel has no backward:
`bn_epilogue` raises where autograd would record it (grad mode on and an
input that requires grad).
"""
from __future__ import annotations

import ctypes

import torch

from keypoint_bench_tpu_torch.ops._build import Kernel
from keypoint_bench_tpu_torch.utils import profiling
from keypoint_bench_tpu_torch.utils.debug_nans import check_kernel_outputs

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = Kernel("bn_epilogue", "kbt_bn_epilogue",
                [_P] * 9 + [_I, _I, _I, _L, _I, _L, _P])
_DTYPES = (torch.float32, torch.bfloat16)
_SCHEMA = ("(Tensor x, Tensor? gamma, Tensor? beta, Tensor mean, Tensor var, "
           "float eps=1e-05, bool relu=False, Tensor? residual=None, "
           "Tensor? bias=None) -> Tensor")


def _out_dtype(x, gamma, beta, mean, var, residual, bias) -> torch.dtype:
    """The output's dtype, after checking the arguments: x's dtype, f32
    where a bias is added, then torch's promotion with the residual's."""
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"expected a contiguous NCHW float32 or bfloat16 "
                         f"map, got {tuple(x.shape)} {x.dtype} strides "
                         f"{x.stride()}")
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta come together")
    stats = [t for t in (mean, var, gamma, beta, bias) if t is not None]
    if any(t.dtype != torch.float32 or t.shape != (x.shape[1],)
           or t.device != x.device or not t.is_contiguous() for t in stats):
        raise ValueError("BatchNorm statistics and the conv bias must be "
                         "contiguous float32 [C] tensors on the map's device")
    out = x.dtype if bias is None else torch.float32
    if residual is None:
        return out
    if (residual.shape != x.shape or residual.dtype not in _DTYPES
            or residual.device != x.device or not residual.is_contiguous()):
        raise ValueError(f"the residual must be a contiguous float32 or "
                         f"bfloat16 tensor of the map's shape "
                         f"{tuple(x.shape)} on its device")
    return torch.promote_types(out, residual.dtype)


_LIB = torch.library.Library("kbt", "DEF")
_LIB.define("bn_epilogue" + _SCHEMA)


def bn_epilogue(x: torch.Tensor, gamma, beta, mean, var, eps: float = 1e-5,
                relu: bool = False, residual: torch.Tensor | None = None,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel once: `bn_chain(x, gamma, beta, mean, var, eps,
    relu, residual, bias)` bit for bit, on the current stream, no host
    sync.

    x contiguous NCHW, float32 or bfloat16; mean, var, bias (or None), and
    gamma, beta (both or neither) float32 [C]; residual None or of x's
    shape, float32 or bfloat16, contiguous. Out: x's dtype (f32 with a
    bias), promoted with the residual's. While a torch profiler runs,
    the launch adds 1 to the counter `models.bn_epilogue`
    (`profiling.counter`)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, beta, mean, var, residual, bias)):
        raise RuntimeError("kbt::bn_epilogue has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    return torch.ops.kbt.bn_epilogue(x, gamma, beta, mean, var, eps, relu,
                                     residual, bias)


def _launch(x, gamma, beta, mean, var, eps=1e-5, relu=False, residual=None,
            bias=None):
    # the dispatcher leaves out trailing arguments that equal their defaults
    KERNEL.function()    # builds, or raises, before any launch
    if not x.is_cuda:
        raise ValueError("bn_epilogue takes a CUDA tensor")
    out_dtype = _out_dtype(x, gamma, beta, mean, var, residual, bias)
    rstd = torch.rsqrt(var + eps)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    counter = profiling.counter("models.bn_epilogue", 1, x.device)
    n, c, h, w = x.shape

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        KERNEL.launch(1, x.data_ptr(), ptr(residual), out.data_ptr(),
                      ptr(bias), mean.data_ptr(), rstd.data_ptr(), ptr(gamma),
                      ptr(beta), ptr(counter), int(x.dtype == torch.bfloat16),
                      int(residual is not None
                          and residual.dtype == torch.bfloat16),
                      int(relu), n * c, c, h * w,
                      torch.cuda.current_stream().cuda_stream)
    check_kernel_outputs(KERNEL.symbol, out)
    return out


# every backend: a CPU map reaches `_launch`, which builds or raises
_LIB.impl("bn_epilogue", _launch, "CompositeExplicitAutograd")


@torch.library.register_fake("kbt::bn_epilogue", lib=_LIB)
def _(x, gamma, beta, mean, var, eps=1e-5, relu=False, residual=None,
      bias=None):
    return x.new_empty(x.shape, dtype=_out_dtype(x, gamma, beta, mean, var,
                                                 residual, bias))
