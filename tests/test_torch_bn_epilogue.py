"""The eval BatchNorm epilogue's plain path (CPU): `bn_eval` with its
bias, ReLU and residual forms equals, bit for bit, the op chain the models
wrote before the epilogue became one function: the conv's bias added,
`bn_eval` alone, then `+ idn`, then `relu`. That chain is the CUDA
kernel's plain twin (`tests/test_torch_kernels_cuda.py` holds the kernel
to it on the card). `conv_bn` on the CPU is the conv with its bias, then
the chain, as before. The operator `kbt::bn_epilogue` on meta tensors: its
fake implementation's dtypes and checks, and its refusal of autograd.

Bits are compared as integers, NaN matching NaN; -0.0 and +0.0 differ.
The inputs hold NaN, +-inf and -0.0, and a channel whose mean is 0 and
beta -0.0, so that -0.0 reaches the ReLU.
"""
import numpy as np
import pytest
import torch

from keypoint_bench_tpu_torch.models import common as c
from keypoint_bench_tpu_torch.ops import cuda_bn


def _literal_chain(x, gamma, beta, mean, var, relu, residual, bias=None):
    """The models' op chain before the epilogue took `relu`, `residual`
    and `bias`: the conv's bias added, the BatchNorm transform stored in
    x's dtype, the residual added, clamp_min."""
    def ch(v):
        return v[:, None, None]
    if bias is not None:
        x = x + ch(bias)
    y = (x.float() - ch(mean)) * ch(torch.rsqrt(var + 1e-5))
    if gamma is not None:
        y = y * ch(gamma) + ch(beta)
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.clamp_min(y, 0) if relu else y


def epilogue_inputs(shape, dtype, affine, res_dtype, seed=0):
    """x [N,C,H,W] of `dtype` with NaN, +-inf and -0.0 planted; f32
    statistics (channel 0: mean 0, beta -0.0); a residual of `res_dtype`
    or None; an f32 conv bias (channel 0: -0.0)."""
    rng = np.random.default_rng(seed)
    n, ch, h, w = shape
    x = rng.normal(size=shape).astype(np.float32) * 3
    flat = x.reshape(-1)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
    at = rng.choice(flat.size, size=min(flat.size, 5 * 7), replace=False)
    flat[at] = np.resize(specials, at.size)
    x = torch.from_numpy(x).to(dtype)
    mean = rng.normal(size=ch).astype(np.float32)
    mean[0] = 0.0
    var = rng.random(ch).astype(np.float32) * 2
    gamma = beta = None
    if affine:
        gamma = torch.from_numpy(rng.normal(size=ch).astype(np.float32))
        b = rng.normal(size=ch).astype(np.float32)
        b[0] = -0.0
        beta = torch.from_numpy(b)
    res = None
    if res_dtype is not None:
        r = rng.normal(size=shape).astype(np.float32) * 2
        r.reshape(-1)[rng.choice(r.size, size=min(r.size, 3),
                                 replace=False)] = -0.0
        res = torch.from_numpy(r).to(res_dtype)
    bias = rng.normal(size=ch).astype(np.float32)
    bias[0] = -0.0
    return (x, gamma, beta, torch.from_numpy(mean), torch.from_numpy(var),
            res, torch.from_numpy(bias))


def same_bits(got, want):
    """Equal dtype, shape and bits; any NaN matches any NaN. Leaves that
    are not tensors (a forward's None) are equal."""
    if not isinstance(want, torch.Tensor):
        assert got == want
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    if not want.is_floating_point():
        assert torch.equal(got, want)
        return
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        want.element_size()]
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("res_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_eval_equals_the_op_chain_on_cpu(dtype, res_dtype, affine, relu,
                                            with_bias):
    x, gamma, beta, mean, var, res, bias = epilogue_inputs(
        (2, 5, 6, 7), dtype, affine, res_dtype)
    bias = bias if with_bias else None
    got = c.bn_eval(x, gamma, beta, mean, var, relu=relu, residual=res,
                    bias=bias)
    same_bits(got, _literal_chain(x, gamma, beta, mean, var, relu, res,
                                  bias))


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_conv_bn_on_cpu_is_the_conv_with_its_bias_then_the_chain(wdtype,
                                                                 affine):
    """On the CPU `conv_bn` leaves the bias in the convolution (the kernel
    takes it only on the card): the models' bits there do not move."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 9, 8, generator=g)
    w = torch.randn(5, 3, 3, 3, generator=g).to(wdtype)
    b = torch.randn(5, generator=g)
    _, gamma, beta, mean, var, res, _ = epilogue_inputs(
        (2, 5, 9, 8), torch.float32, affine, torch.float32)
    got = c.conv_bn(x, w, b, (gamma, beta, mean, var), 1, 2, 2, relu=True,
                    residual=res)
    want = _literal_chain(c.conv2d(x, w, b, 1, 2, 2), gamma, beta, mean, var,
                          True, res)
    same_bits(got, want)


@pytest.mark.parametrize("bias,res_dtype,want", [
    (False, None, torch.bfloat16), (True, None, torch.float32),
    (False, torch.float32, torch.float32),
    (True, torch.bfloat16, torch.float32),
    (False, torch.bfloat16, torch.bfloat16)])
def test_bn_epilogue_op_output_dtype_on_meta(bias, res_dtype, want):
    """The operator's fake implementation (what torch.export and
    torch.compile record) gives the chain's dtype for a bf16 map."""
    x = torch.empty(2, 3, 4, 5, dtype=torch.bfloat16, device="meta")
    s = torch.empty(3, device="meta")
    res = None if res_dtype is None else x.to(res_dtype)
    with torch.no_grad():
        out = cuda_bn.bn_epilogue(x, s, s, s, s, 1e-5, True, res,
                                  s if bias else None)
    assert out.dtype == want and out.shape == x.shape
    assert out.dtype == c.bn_chain(
        torch.zeros(2, 3, 4, 5, dtype=torch.bfloat16), *[torch.ones(3)] * 4,
        relu=True, residual=None if res is None else torch.zeros(
            2, 3, 4, 5, dtype=res_dtype),
        bias=torch.zeros(3) if bias else None).dtype


def test_bn_epilogue_op_checks_its_arguments_on_meta():
    x = torch.empty(2, 3, 4, 5, device="meta")
    s = torch.empty(3, device="meta")
    bad = [dict(x=x.to(memory_format=torch.channels_last)),
           dict(x=x.half()), dict(x=x[0]), dict(beta=None),
           dict(mean=s.double()), dict(var=s[:2]), dict(bias=s[:2]),
           dict(residual=x[:, :2]), dict(residual=x.transpose(2, 3))]
    for kw in bad:
        args = dict(x=x, gamma=s, beta=s, mean=s, var=s, residual=None,
                    bias=None)
        args.update(kw)
        with pytest.raises(ValueError), torch.no_grad():
            cuda_bn.bn_epilogue(args["x"], args["gamma"], args["beta"],
                                args["mean"], args["var"], 1e-5, True,
                                args["residual"], args["bias"])


def test_bn_epilogue_op_refuses_autograd():
    """The kernel has no backward: with grad mode on and an input that
    requires grad the operator raises; under no_grad it runs."""
    x = torch.empty(2, 3, 4, 5, device="meta", requires_grad=True)
    s = torch.empty(3, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_bn.bn_epilogue(x, None, None, s, s)
    with torch.no_grad():
        assert not cuda_bn.bn_epilogue(x, None, None, s, s).requires_grad
