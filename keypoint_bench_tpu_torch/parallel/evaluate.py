"""Data-parallel batched evaluation (counterpart of
keypoint_bench_tpu/parallel/evaluate.py): the detect -> warp -> match ->
solve -> metric pipeline over a batch of pairs, the pairs split into
contiguous blocks over the mesh's 'data' ranks (JAX's P("data")).

Each rank runs the batched head on its block: one forward per image set,
detection (kernel A on CUDA), and for Alike_s2d the sparse sampler (kernel
B) in place of the dense map (`pipeline.detect_frames`); then mutual NN
(kernel D) and the per-pair tails as the port's batched functions
(warp_homography, repeatability_pair, RANSAC-H / mha_pair, RANSAC-E +
recoverPose / pose_error). The per-pair outputs are all-gathered in pair
order, so every rank returns the whole batch's.

Randomness does not depend on the rank: pair j's RANSAC samples come from
a generator seeded with seeds[j] (`pair_samples`), the seeds drawn for the
whole batch by the caller, so world sizes 1, 2 and 4 give the same
outputs wherever the forward does. The forward runs on each rank's block:
on the CPU a block of 2 or more images gives the same maps whatever its
size, a block of 1 does not (oneDNN takes another path at batch 1).

Each `sharded_*_step(mesh, ...)` returns a `ShardedStep`: called with the
whole batch (as the JAX step is) it takes this rank's block; `.shard`
takes the block alone, for callers that load only their own pairs.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.geometry.ransac import (
    peel_samples, ransac_homography_from_samples)
from keypoint_bench_tpu_torch.geometry.warp import warp_homography
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.ops.matching import brute_force_match
from keypoint_bench_tpu_torch.parallel.mesh import Mesh
from keypoint_bench_tpu_torch.pipeline import (_check_weights, detect_frames,
                                               match_sparse)
from keypoint_bench_tpu_torch.tasks.auc import (estimate_pose_pair,
                                                pose_error,
                                                ransac_sample_shape)
from keypoint_bench_tpu_torch.tasks.mha import mha_pair
from keypoint_bench_tpu_torch.tasks.repeatability import repeatability_pair
from keypoint_bench_tpu_torch.utils import profiling

N_HYP_H = 256     # RANSAC-H hypotheses of the batched steps (JAX's)


def pair_samples(mask: torch.Tensor, seeds, n_hyp: int,
                 size: int) -> torch.Tensor:
    """[b, n_hyp, size] minimal samples of the valid entries of mask
    [b, K]: pair j's uniform draws from a generator on mask's device
    seeded with seeds[j], whatever rank draws them; `_sample_minimal` of
    one pair with that generator gives the same samples."""
    with profiling.span("kbt.geometry.ransac.samples"):
        u = []
        for seed in seeds:
            g = torch.Generator(device=mask.device).manual_seed(int(seed))
            u.append(torch.rand((n_hyp, mask.shape[-1]), generator=g,
                                device=mask.device))
        return peel_samples(mask, torch.stack(u), size)


def block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of a batch of n pairs."""
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} pairs does not split over "
                         f"{mesh.n_data} data ranks")
    b = n // mesh.n_data
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def gather_pairs(mesh: Mesh, outs):
    """Per-pair outputs of every data rank's block, concatenated in pair
    order: outs a tensor or a tuple / dict of tensors with the block on
    dim 0. One all_gather: the values travel as float64 (exact for f32
    and for integers below 2^53) and come back in their own dtypes."""
    keys = list(outs) if isinstance(outs, dict) else None
    parts = list(outs.values()) if keys else (
        [outs] if isinstance(outs, torch.Tensor) else list(outs))
    b = parts[0].shape[0]
    flat = torch.cat([p.reshape(b, -1).double() for p in parts], dim=1)
    full = torch.cat(mesh.all_gather(flat, "data"))
    got, i = [], 0
    for p in parts:
        w = p[0].numel()
        got.append(full[:, i:i + w].to(p.dtype).reshape(-1, *p.shape[1:]))
        i += w
    if keys:
        return dict(zip(keys, got))
    return got[0] if isinstance(outs, torch.Tensor) else tuple(got)


def _per_size(sizes, fn, *args):
    """fn(width, height, *args) over each group of pairs that share a
    (width, height) of sizes [b, 2] (numpy); its outputs (a tuple of
    tensors [g, ...]) put back in pair order."""
    sizes = np.asarray(sizes, np.float64)
    keys = sorted({(float(w), float(h)) for w, h in sizes})
    if len(keys) == 1:
        return fn(*keys[0], *args)
    outs = None
    for w, h in keys:
        idx = torch.as_tensor(np.flatnonzero((sizes == (w, h)).all(1)),
                              device=args[0].device)
        part = fn(w, h, *(a[idx] for a in args))
        if outs is None:
            outs = [p.new_empty((len(sizes), *p.shape[1:])) for p in part]
        for o, p in zip(outs, part):
            o[idx] = p
    return tuple(outs)


def forward_detect(model, detect_params: DetectParams, imgs0, imgs1,
                   sparse: bool, device):
    """The batched head of every step: (k0, v0, d0, k1, v1, d1) of the
    two image sets, one forward + detection a set; d* are the dense maps,
    or with `sparse` (ALIKE) the [b, K, 64] keypoint descriptors of the
    sparse sampler; None for a detector-only model."""
    out = []
    for imgs in (imgs0, imgs1):
        _, d, k, v = detect_frames(model, imgs, detect_params, device,
                                   sparse, chunk=max(len(imgs), 1))
        out += [k, v, d]
    return out


def match_block(k0, va, k1, vb, d0, d1, max_distance: float, sparse: bool,
                match_dtype=None):
    """(m0, m1, ok): the mutual-NN matches of a block of pairs (kernel D
    on CUDA). On the sparse path d0 / d1 are the keypoint descriptors
    (`pipeline.match_sparse`, in `match_dtype` where given); dense maps are
    sampled at the keypoints (brute_force_match)."""
    with profiling.span("kbt.ops.match"):
        if sparse:
            m1, ok = match_sparse(k1, d0, d1, va, vb, max_distance,
                                  match_dtype)
            return k0, m1, ok
        return brute_force_match(k0, va, k1, vb, d0, d1, max_distance)


def _tensor(x, dev) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _warps(sizes, k0, v0, k1, v1, Hs, Hinvs):
    """warp_homography of both sides at each pair's (width, height)."""
    def warp(w, h, k0, v0, k1, v1, H, Hi):
        return (*warp_homography(k0, v0, H, w, h),
                *warp_homography(k1, v1, Hi, w, h))
    with profiling.span("kbt.geometry.warp"):
        return _per_size(sizes, warp, k0, v0, k1, v1, Hs, Hinvs)


@torch.inference_mode()
def batched_repeatability_step(model, detect_params: DetectParams, imgs0,
                               imgs1, Hs, Hinvs, sizes, scales, seeds,
                               th: float = 3.0, bf_max_distance: float = 5.0,
                               sparse: bool = False, match_dtype=None,
                               device="cuda") -> dict:
    """b homography pairs imgs0 / imgs1 [b,H,W,3] (float in [0,1] or
    uint8) with Hs / Hinvs [b,3,3], sizes [b,2] (width, height), scales
    [b] and RANSAC seeds [b] -> per-pair repeatability, mean_error,
    num_feat (float), gt_num and homography_inliers (float; 0 for a
    detector-only model), each [b], on `device`."""
    with profiling.span("kbt.step.repeatability"):
        device = resolve_device(device)
        _check_weights(model.params, device)
        k0, v0, d0, k1, v1, d1 = forward_detect(model, detect_params, imgs0,
                                                imgs1, sparse, device)
        sizes = _host(sizes)
        a0, a01, va, b0, b10, vb = _warps(sizes, k0, v0, k1, v1,
                                          _tensor(Hs, device),
                                          _tensor(Hinvs, device))
        rep = repeatability_pair(k0, v0, k1, v1, a0, a01, va, b0, b10, vb,
                                 _tensor(scales, device), th)
        n_inl = torch.zeros(len(sizes), device=device)
        if d0 is not None:
            m0, m1, ok = match_block(k0, va, k1, vb, d0, d1, bf_max_distance,
                                     sparse, match_dtype)
            s = torch.as_tensor(sizes - 1.0, dtype=torch.float32,
                                device=device)[:, None, :]
            _, inl, ok_h = ransac_homography_from_samples(
                m0[..., 0:2] * s, m1[..., 0:2] * s, ok,
                pair_samples(ok, seeds, N_HYP_H, 4))
            n_inl = torch.where(ok_h, inl.sum(-1), 0).float()
        return {"repeatability": rep["repeatability"],
                "mean_error": rep["mean_error"],
                "num_feat": rep["num_feat"].float(), "gt_num": rep["gt_num"],
                "homography_inliers": n_inl}


@torch.inference_mode()
def batched_mha_step(model, detect_params: DetectParams, imgs0, imgs1, Hs,
                     Hinvs, sizes, seeds, thresholds=(3.0, 5.0, 7.0),
                     bf_max_distance: float = 5.0, sparse: bool = False,
                     match_dtype=None, device="cuda") -> torch.Tensor:
    """b homography pairs (inputs as `batched_repeatability_step`) -> the
    MHA hit matrix [b, len(thresholds)]: matches between the covisible
    keypoints, RANSAC-H with 256 hypotheses, the corner test."""
    with profiling.span("kbt.step.mha"):
        device = resolve_device(device)
        _check_weights(model.params, device)
        k0, v0, d0, k1, v1, d1 = forward_detect(model, detect_params, imgs0,
                                                imgs1, sparse, device)
        if d0 is None:
            raise ValueError("MHA matches descriptors; the model has none")
        sizes = _host(sizes)
        Hs = _tensor(Hs, device)
        _, _, va, _, _, vb = _warps(sizes, k0, v0, k1, v1, Hs,
                                    _tensor(Hinvs, device))
        m0, m1, ok = match_block(k0, va, k1, vb, d0, d1, bf_max_distance,
                                 sparse, match_dtype)
        h_img, w_img = imgs0.shape[1], imgs0.shape[2]

        def tail(w, h, m0, m1, ok, H, idx):
            return (mha_pair(m0, m1, ok, H, w, h, h_img, w_img,
                             thresholds=thresholds, n_hyp=N_HYP_H,
                             sample_idx=idx),)

        return _per_size(sizes, tail, m0, m1, ok, Hs,
                         pair_samples(ok, seeds, N_HYP_H, 4))[0]


@torch.inference_mode()
def batched_auc_step(model, detect_params: DetectParams, imgs0, imgs1, K0s,
                     K1s, poses01, seeds, solver: str = "8pt",
                     n_hyp: int = 4096, bf_max_distance: float = 5.0,
                     sparse: bool = False, match_dtype=None, device="cuda"):
    """b SE3 pairs imgs0 / imgs1 [b,H,W,3] with intrinsics K0s / K1s
    [b,3,3], ground-truth poses01 [b,4,4] and RANSAC seeds [b] -> (pose
    errors [b] in degrees, 180 where the pose failed; inlier counts [b],
    0 there). Essential RANSAC ("8pt" or "5pt") + recoverPose on the
    mutual-NN matches of all keypoints."""
    with profiling.span("kbt.step.auc"):
        device = resolve_device(device)
        _check_weights(model.params, device)
        k0, v0, d0, k1, v1, d1 = forward_detect(model, detect_params, imgs0,
                                                imgs1, sparse, device)
        if d0 is None:
            raise ValueError("AUC matches descriptors; the model has none")
        m0, m1, ok = match_block(k0, v0, k1, v1, d0, d1, bf_max_distance,
                                 sparse, match_dtype)
        h0, w0 = imgs0.shape[1:3]
        h1, w1 = imgs1.shape[1:3]
        p0 = m0[..., 0:2] * torch.tensor([w0 - 1.0, h0 - 1.0],
                                         device=device)
        p1 = m1[..., 0:2] * torch.tensor([w1 - 1.0, h1 - 1.0],
                                         device=device)
        R, t, _, n_in, okp = estimate_pose_pair(
            p0, p1, ok, _tensor(K0s, device), _tensor(K1s, device), None,
            n_hyp=n_hyp, solver=solver, samples=pair_samples(
                ok, seeds, *ransac_sample_shape(solver, n_hyp)))
        with profiling.span("kbt.geometry.pose_error"):
            err = pose_error(R, t, _tensor(poses01, device))
            err = torch.where(okp, err, torch.full_like(
                okp, 180.0, dtype=torch.float32))
        return err, torch.where(okp, n_in, torch.zeros_like(n_in))


class ShardedStep:
    """A batched step over the mesh's 'data' ranks: `step(*batch)` on the
    whole batch (every rank passes the same) takes this rank's contiguous
    block; `step.shard(*block)` on this rank's block alone. Both return
    the whole batch's per-pair outputs in pair order, on every rank."""

    def __init__(self, mesh: Mesh, fn):
        self.mesh, self.fn = mesh, fn

    def __call__(self, *batch):
        sl = block(self.mesh, len(batch[0]))
        return self.shard(*(x[sl] for x in batch))

    def shard(self, *inputs):
        return gather_pairs(self.mesh, self.fn(*inputs,
                                               device=self.mesh.device))


def sharded_eval_step(mesh: Mesh, model, detect_params: DetectParams,
                      th: float = 3.0, bf_max_distance: float = 5.0,
                      sparse: bool = False,
                      match_dtype=None) -> ShardedStep:
    """Data-parallel `batched_repeatability_step`: step(imgs0, imgs1, Hs,
    Hinvs, sizes, scales, seeds) -> the dict of per-pair [B] outputs. The
    model must be on the mesh's device."""
    return ShardedStep(mesh, partial(
        batched_repeatability_step, model, detect_params, th=th,
        bf_max_distance=bf_max_distance, sparse=sparse,
        match_dtype=match_dtype))


def sharded_mha_step(mesh: Mesh, model, detect_params: DetectParams,
                     thresholds=(3.0, 5.0, 7.0), bf_max_distance: float = 5.0,
                     sparse: bool = False,
                     match_dtype=None) -> ShardedStep:
    """Data-parallel `batched_mha_step`: step(imgs0, imgs1, Hs, Hinvs,
    sizes, seeds) -> hits [B, T]."""
    return ShardedStep(mesh, partial(
        batched_mha_step, model, detect_params, thresholds=tuple(thresholds),
        bf_max_distance=bf_max_distance, sparse=sparse,
        match_dtype=match_dtype))


def sharded_auc_step(mesh: Mesh, model, detect_params: DetectParams,
                     solver: str = "8pt", n_hyp: int = 4096,
                     bf_max_distance: float = 5.0, sparse: bool = False,
                     match_dtype=None) -> ShardedStep:
    """Data-parallel `batched_auc_step`: step(imgs0, imgs1, K0s, K1s,
    poses01, seeds) -> (errors [B], inliers [B]). The images of a batch
    share one shape."""
    return ShardedStep(mesh, partial(
        batched_auc_step, model, detect_params, solver=solver, n_hyp=n_hyp,
        bf_max_distance=bf_max_distance, sparse=sparse,
        match_dtype=match_dtype))
