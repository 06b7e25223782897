"""Shared eval-mode blocks (counterpart of keypoint_bench_tpu/models/common.py)
for the port's detector and descriptor models.

These helpers work on NCHW tensors (torch's native conv layout); the model
classes convert at their public boundary, which keeps the JAX package's
NHWC layout. Parameter dicts hold torch-layout tensors (weights/convert.py).

bf16 mode (`cast_params_bf16`) rounds where the JAX package rounds: a conv
with bf16 weights casts its input to bf16 and stores its output in bf16
(f32 accumulation), and an f32 bias is added after it, which promotes the
activation to f32 as jnp's bf16 + f32 does; BatchNorm computes in f32 and
stores back in its input's dtype; bilinear resizes of bf16 maps use bf16
interpolation matrices.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keypoint_bench_tpu_torch.ops import cuda_bn


class ParamModule(nn.Module):
    """A model built from a parameter dict: torch-layout tensors keyed by
    the converted torch names, held as buffers so `.to()` moves them."""

    def __init__(self, params: dict):
        super().__init__()
        self._names = sorted(params)
        for k in self._names:
            self.register_buffer(k.replace(".", "__"), params[k])

    @property
    def params(self) -> dict:
        return {k: getattr(self, k.replace(".", "__")) for k in self._names}


def to_float_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 images scale to [0, 1]; float images pass through as float32."""
    if image.dtype == torch.uint8:
        return image.float() / 255.0
    return image.float()


def nchw_image(image: torch.Tensor) -> torch.Tensor:
    """NHWC image (uint8, or float in [0, 1]) -> contiguous float NCHW. A
    permuted view would be channels-last in memory, and cuDNN would keep
    that format for every activation."""
    return to_float_image(image).permute(0, 3, 1, 2).contiguous()


def gray_mean(image: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """[..., C] -> [...] channel mean times `scale` as the JAX package's
    jitted `jnp.mean(image, -1) * scale` computes it on the CPU: the sum
    in channel order times float32(scale / C) (XLA turns the mean's
    division into a product and folds the constants into one)."""
    total = image[..., 0]
    for i in range(1, image.shape[-1]):
        total = total + image[..., i]
    return total * np.float32(scale / image.shape[-1])


def cast_params_bf16(params: dict) -> dict:
    """bf16 mode's parameters (JAX `models/common.cast_params_bf16`): conv
    and linear weights (rank >= 2) in bf16; BatchNorm statistics, biases
    and other vectors stay f32."""
    return {k: v.to(torch.bfloat16) if v.dim() >= 2 else v
            for k, v in params.items()}


def _with_bias(conv, x: torch.Tensor, w: torch.Tensor, b, *args):
    """`conv` of x with w, in w's dtype (x is cast to it, as the JAX
    package's conv2d does), then the bias. A bias of w's dtype goes into
    the conv; an f32 bias of a bf16 conv is added after it in f32."""
    x = x.to(w.dtype)
    if b is None or b.dtype == w.dtype:
        return conv(x, w, b, *args)
    return conv(x, w, None, *args) + b[:, None, None]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """x [B,Ci,H,W], w [Co,Ci/groups,kh,kw] (OIHW)."""
    return _with_bias(F.conv2d, x, w, b, stride, padding, dilation, groups)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None,
                     stride: int = 2) -> torch.Tensor:
    """nn.ConvTranspose2d(k, stride, padding=0): w is torch's own
    [I, O, kh, kw], which the converter's OIHW round trip gives back."""
    return _with_bias(F.conv_transpose2d, x, w, b, stride)


def bn_eval(x: torch.Tensor, gamma, beta, mean, var, eps: float = 1e-5,
            relu: bool = False, residual: torch.Tensor | None = None,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """The eval BatchNorm epilogue of a convolution: `bn_chain` on the CPU;
    on the card one pass of the CUDA kernel (ops/cuda_bn.py, the operator
    `kbt::bn_epilogue`), which gives the chain's bits and raises on a map
    that is not contiguous NCHW."""
    if x.is_cuda:
        return cuda_bn.bn_epilogue(x, gamma, beta, mean, var, eps, relu,
                                   residual, bias)
    return bn_chain(x, gamma, beta, mean, var, eps, relu, residual, bias)


def bn_chain(x: torch.Tensor, gamma, beta, mean, var, eps: float = 1e-5,
             relu: bool = False, residual: torch.Tensor | None = None,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """BatchNorm inference transform, in the JAX package's operation order:
    (x - mean) * rsqrt(var + eps) * gamma + beta, per channel of NCHW, in
    f32 and stored back in x's dtype; then `+ residual` (torch's dtype
    promotion) and ReLU where asked. gamma and beta None: BatchNorm
    without affine (the JAX package's 1.0 and 0.0, whose product and sum
    change nothing). bias: a conv's bias not yet added, added first as
    torch adds it after cuDNN's convolution (x + bias, in f32)."""
    def c(v):
        return v[:, None, None]
    if bias is not None:
        x = x + c(bias)
    y = (x.float() - c(mean)) * c(torch.rsqrt(var + eps))
    if gamma is not None:
        y = y * c(gamma) + c(beta)
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.clamp_min(y, 0) if relu else y    # relu(), shadowed here


def conv_bn(x: torch.Tensor, w: torch.Tensor, b, bn: tuple,
            stride: int = 1, padding: int = 0, dilation: int = 1,
            groups: int = 1, relu: bool = False,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """`conv2d` then `bn_eval`, bn = (gamma, beta, running_mean,
    running_var). On the card an f32 conv bias is the epilogue's first
    step: torch adds it after cuDNN's convolution in a pass of its own,
    with the same f32 rounding (as `_with_bias` adds an f32 bias to a bf16
    conv). Not for a grouped conv, which may run torch's depthwise kernel,
    whose sum takes the bias in; nor on the CPU, where the conv adds it."""
    fold = (x.is_cuda and groups == 1 and b is not None
            and b.dtype == torch.float32)
    y = conv2d(x, w, None if fold else b, stride, padding, dilation, groups)
    return bn_eval(y, *bn, relu=relu, residual=residual,
                   bias=b if fold else None)


def instance_norm(x: torch.Tensor, gamma=None, beta=None,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d of NCHW x: statistics over H, W per sample and
    channel, biased variance, in the JAX package's order
    (x - mean) * rsqrt(var + eps), then * gamma + beta where given."""
    mean = x.mean((-2, -1), keepdim=True)
    var = x.var((-2, -1), unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma[:, None, None] + beta[:, None, None]
    return y


def max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride k, VALID padding."""
    return F.max_pool2d(x, k, k)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool, stride k, VALID padding."""
    return F.avg_pool2d(x, k, k)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU of NCHW x with per-channel alpha [C]."""
    return torch.where(x >= 0, x, x * alpha[:, None, None])


def _depthwise(xp: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """One f32 [kh, kw] kernel applied to every channel of the padded NCHW
    xp (a VALID cross-correlation, in f32 as the JAX package's f32 kernel
    makes it)."""
    c = xp.shape[1]
    w = torch.from_numpy(np.array(np.broadcast_to(k, (c, 1, *k.shape)),
                                  np.float32)).to(xp.device)
    return F.conv2d(xp.float(), w, groups=c)


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0


def sobel_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kornia-style normalized Sobel (kernel / 8) with replicate padding
    of NCHW x -> (dx, dy), each NCHW (KeyNet's handcrafted block)."""
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return _depthwise(xp, _SOBEL_X), _depthwise(xp, _SOBEL_X.T.copy())


_PYR = np.array([1., 4., 6., 4., 1.], np.float32)


def gaussian_pyr_blur(x: torch.Tensor) -> torch.Tensor:
    """5 x 5 [1,4,6,4,1]^2 / 256 blur of NCHW x with reflect padding
    (torch's reflect is REFLECT_101, as jnp.pad's; KeyNet's pyrdown)."""
    xp = F.pad(x, (2, 2, 2, 2), mode="reflect")
    return _depthwise(xp, np.outer(_PYR, _PYR) / 256.0)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 0.0) -> torch.Tensor:
    """x / |x| along `dim` (plus eps in the denominator when given)."""
    n = torch.sqrt((x * x).sum(dim, keepdim=True))
    return x / (n + eps) if eps else x / n


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """NCHW [B, block*block, Hc, Wc] -> [B, 1, Hc*block, Wc*block] with the
    SuperPoint heatmap layout: channels-last reshape to
    [B, Hc, Wc, block, block], then permute (0, 1, 3, 2, 4)."""
    b, cc, hc, wc = x.shape
    if cc != block * block:
        raise ValueError(f"expected {block * block} channels, got {cc}")
    y = x.permute(0, 2, 3, 1).reshape(b, hc, wc, block, block)
    y = y.permute(0, 1, 3, 2, 4)
    return y.reshape(b, 1, hc * block, wc * block)


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Row-stochastic [n_out, n_in] bilinear matrix with align_corners=True
    (src = i * (n_in-1)/(n_out-1)), as keypoint_bench_tpu's
    models/common._interp_matrix builds it."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    i = np.arange(n_out)
    src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else np.zeros(1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - lo
    a = np.zeros((n_out, n_in), np.float32)
    a[i, lo] = 1 - frac
    a[i, lo + 1] = frac
    return a


@functools.lru_cache(maxsize=64)
def _interp_matrix_half(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear matrix with the half-pixel mapping
    (align_corners=False: src = (i + 0.5) * n_in / n_out - 0.5, clamped to
    the edges), as keypoint_bench_tpu's models/common._interp_matrix_half
    builds it."""
    i = np.arange(n_out)
    src = np.clip((i + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, max(n_in - 2, 0))
    frac = src - lo
    a = np.zeros((n_out, n_in), np.float32)
    a[i, lo] = 1 - frac
    a[i, np.minimum(lo + 1, n_in - 1)] += frac
    return a


def _interp_apply(x: torch.Tensor, ah: np.ndarray,
                  aw: np.ndarray) -> torch.Tensor:
    """Two dense interpolation products over NCHW x, rows then columns,
    as the JAX package computes a bilinear resize: in x's dtype, with
    bf16 matrices (and each product stored in bf16) for a bf16 x."""
    def mat(a):
        return torch.from_numpy(a).to(x.device, x.dtype)
    y = torch.einsum("oh,bchw->bcow", mat(ah), x)
    return torch.einsum("pw,bcow->bcop", mat(aw), y)


def resize_bilinear_align(x: torch.Tensor, out_h: int,
                          out_w: int) -> torch.Tensor:
    """F.interpolate(bilinear, align_corners=True) of NCHW x, computed as
    two dense interpolation products like the JAX package does."""
    return _interp_apply(x, _interp_matrix(out_h, x.shape[-2]),
                         _interp_matrix(out_w, x.shape[-1]))


def resize_bilinear_half_pixel(x: torch.Tensor, out_h: int,
                               out_w: int) -> torch.Tensor:
    """F.interpolate(bilinear, align_corners=False) of NCHW x, from the
    same cached half-pixel matrices as the JAX package."""
    return _interp_apply(x, _interp_matrix_half(out_h, x.shape[-2]),
                         _interp_matrix_half(out_w, x.shape[-1]))


def upsample_bilinear_align(x: torch.Tensor, factor: int) -> torch.Tensor:
    return resize_bilinear_align(x, x.shape[-2] * factor,
                                 x.shape[-1] * factor)


def conv_bn_relu(x, p, conv: str, bn: str, stride: int = 1,
                 padding: int = 1):
    return conv_bn(x, p[f"{conv}.weight"], p.get(f"{conv}.bias"),
                   bn_params(p, bn), stride, padding, relu=True)


def bn_params(p, bn: str) -> tuple:
    """(gamma, beta, running_mean, running_var) of BatchNorm `bn`."""
    return tuple(p[f"{bn}.{k}"] for k in ("weight", "bias", "running_mean",
                                           "running_var"))


def conv_block(x, p, prefix: str):
    """conv3x3 + BN + ReLU, twice."""
    y = conv_bn_relu(x, p, f"{prefix}.conv1", f"{prefix}.bn1")
    return conv_bn_relu(y, p, f"{prefix}.conv2", f"{prefix}.bn2")


def res_block(x, p, prefix: str, stride: int = 1):
    """conv-bn-relu, conv-bn, plus a 1x1 downsample identity, then relu."""
    idn = conv2d(x, p[f"{prefix}.downsample.weight"],
                 p.get(f"{prefix}.downsample.bias"), 1, 0)
    y = conv_bn_relu(x, p, f"{prefix}.conv1", f"{prefix}.bn1", stride)
    return conv_bn(y, p[f"{prefix}.conv2.weight"],
                   p.get(f"{prefix}.conv2.bias"),
                   bn_params(p, f"{prefix}.bn2"), 1, 1, relu=True,
                   residual=idn)
