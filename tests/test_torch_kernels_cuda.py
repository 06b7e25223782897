"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

Marked `cuda`: they skip on a host without a GPU. On the card run
`python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py`. This file
imports torch only (the card's machine has no JAX).

Tolerances: kernel A (NMS) is bit-exact; kernel B (sampler) within 1e-5
absolute of the plain gather (f32 sums of the same products, another
order).
"""
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from keypoint_bench_tpu_torch.ops import cuda_nms, cuda_sample
from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                 detection_batch, fast_nms)
from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _maps(kind, shape, seed):
    rng = np.random.default_rng(seed)
    m = rng.random(shape).astype(np.float32)
    if kind != "random":
        m = ndi.gaussian_filter(m, (0, 2.0, 2.0)).astype(np.float32)
    if kind == "signed":
        m = m - 0.5
    t = torch.from_numpy(m)
    if kind == "ties_bf16":
        t = (torch.round(t * 8) / 8).to(torch.bfloat16)
    return t


@pytest.mark.parametrize("d", [1, 2, 4, 6, 16])
@pytest.mark.parametrize("kind", ["random", "smooth", "ties_bf16", "signed"])
def test_nms_kernel_bit_exact(dev, kind, d):
    maps = _maps(kind, (3, 100, 130), d)
    got = cuda_nms.nms_cuda(maps.to(dev), d, 30)
    want = fast_nms(maps.to(dev), d, 30)
    assert got.dtype == maps.dtype
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), fast_nms(maps, d, 30))


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_nms_kernel_respects_max_iter(dev, max_iter):
    maps = _maps("smooth", (2, 64, 96), 7).to(dev)
    assert torch.equal(cuda_nms.nms_cuda(maps, 4, max_iter),
                       fast_nms(maps, 4, max_iter))


def _sample_case(dev, b, k, seed,
                 shapes=((160, 224), (80, 112), (20, 28), (5, 7))):
    rng = np.random.default_rng(seed)
    h, w = shapes[0]
    feats = tuple(torch.from_numpy(rng.random((b, 16, hh, ww),
                                              np.float32)).to(dev)
                  for hh, ww in shapes)
    px = torch.from_numpy(rng.uniform(0, w - 1, (b, k)).astype(
        np.float32)).to(dev)
    py = torch.from_numpy(rng.uniform(0, h - 1, (b, k)).astype(
        np.float32)).to(dev)
    edges = torch.tensor([0.0, w - 1.0, w - 1.5], device=dev)[:k]
    px[:, :len(edges)] = edges
    return feats, px, py, h, w


@pytest.mark.parametrize("b,k", [(1, 1), (2, 300), (3, 1000)])
def test_sample_kernel_matches_plain(dev, b, k):
    args = _sample_case(dev, b, k, k)
    got = cuda_sample.sample_cuda(*args)
    want = sample_branches(*args)
    assert got.shape == (b, 64, k)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("lo", [(2, 2), (3, 2), (3, 3)])
def test_sample_kernel_tiny_branches_match_dense_resize(dev, lo):
    """Branches of 2 or 3 rows: the plain twin resizes densely, as the
    reference does; the kernel's composite taps give the same samples."""
    shapes = ((64, 64), (32, 32), (8, 8), lo)
    args = _sample_case(dev, 2, 200, 5, shapes)
    got = cuda_sample.fused_samples_batch(*args)
    want = sample_branches(*args)
    assert float((got - want).abs().max()) <= 1e-5


def test_sample_kernel_rejects_bad_input(dev):
    feats, px, py, h, w = _sample_case(dev, 1, 10, 0)
    with pytest.raises(ValueError):
        cuda_sample.sample_cuda(feats, px.double(), py, h, w)
    with pytest.raises(ValueError):
        cuda_sample.sample_cuda(feats, px.cpu(), py, h, w)
    one_row = feats[:3] + (feats[3][:, :, :1].contiguous(),)
    with pytest.raises(ValueError):
        cuda_sample.fused_samples_batch(one_row, px, py, h, w)
    assert cuda_sample.sample_cuda(feats, px[:, :0].contiguous(),
                                   py[:, :0].contiguous(), h, w).numel() == 0


def test_detection_on_card_matches_cpu_and_counts_launches(dev):
    maps = _maps("smooth", (2, 128, 128), 3)
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=300)
    before = cuda_nms.KERNEL.launches
    k, v = detection_batch(maps.to(dev), dp)
    assert cuda_nms.KERNEL.launches == before + 1 + 2 * dp.max_nms_iter
    k_cpu, v_cpu = detection_batch(maps, dp)
    assert torch.equal(k.cpu(), k_cpu) and torch.equal(v.cpu(), v_cpu)
