"""The port's batched steps over image pairs.

`extract_match`: ALIKE-t extract + brute-force mutual-NN match (counterpart
of bench.py's default extract_match step, bench.py:594-622, at float32):
features -> detection_batch (NMS kernel A) -> y-ordered sparse descriptors
(sampler kernel B) -> mutual_nn_match (kernel D) -> take_rows.

`superpoint_mha_step`: SuperPoint -> brute-force or LightGlue matching ->
RANSAC-H MHA (counterpart of bench.py:98-218 `bench_superpoint_mha`, at
float32): SuperPoint x2 -> detection_batch (kernel A) -> covisibility warp
-> mutual_nn_match on descriptors sampled from the 1/8 map (kernel D) or
LightGlue (kernel E) -> mha_pair.

`lk_fundamental_step`: ALIKE-t -> detection -> pyramidal Lucas-Kanade
tracking into the next frame -> epipolar error against the ground-truth
fundamental matrix (counterpart of bench.py:434-446, the step of
`bench_lk_fund`, at float32): forward of imgs0 only -> detection_batch
(kernel A) -> optical_flow_batch (kernel F, one launch per level) ->
fundamental_metrics.

`xfeat_auc_step`: XFeat -> LightGlue -> essential RANSAC -> recoverPose ->
pose error (counterpart of bench.py:275-293, the step of
`bench_xfeat_auc`, at float32): XFeat x2 -> detection_batch (kernel A) ->
descriptors sampled from the 1/8 map -> lightglue_forward with the
64 -> 256 input projection (kernel E) -> estimate_pose_pair -> pose_error,
a failed pair counting 180 degrees.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.geometry.warp import warp_homography
from keypoint_bench_tpu_torch.models.common import to_float_image
from keypoint_bench_tpu_torch.models.lightglue import (lightglue_forward,
                                                       lightglue_match,
                                                       sample_descriptors_lg)
from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection_batch
from keypoint_bench_tpu_torch.ops.lk import LKParams, optical_flow_batch
from keypoint_bench_tpu_torch.ops.matching import (brute_force_match,
                                                   mutual_nn_match, take_rows)
from keypoint_bench_tpu_torch.ops.sparse_desc import \
    alike_sparse_descriptors_cm_batch_yorder
from keypoint_bench_tpu_torch.tasks.auc import estimate_pose_pair, pose_error
from keypoint_bench_tpu_torch.tasks.fundamental import fundamental_metrics
from keypoint_bench_tpu_torch.tasks.mha import mha_pair

MATCHERS = ("brute_force", "light_glue")


def _check_weights(params: dict, dev: torch.device):
    w_dev = next(iter(params.values())).device
    if w_dev.type != dev.type or (dev.index is not None
                                  and w_dev.index != dev.index):
        raise ValueError(f"params are on {w_dev}, the step runs on {dev}: "
                         f"load them with load_params(..., device=)")


def extract(model, params: dict, imgs: torch.Tensor, dp: DetectParams):
    """One image batch -> (desc [B,K,64], kpts [B,K,3], valid [B,K]) in the
    sampler's y order."""
    h, w = imgs.shape[1], imgs.shape[2]
    score, feats = model.feats(imgs)
    kpts, valid = detection_batch(score, dp)
    desc, kpts, valid = alike_sparse_descriptors_cm_batch_yorder(
        params, feats, kpts, valid, h, w)
    return desc, kpts, valid


@torch.inference_mode()
def extract_match(model, params: dict, imgs0, imgs1,
                  detect_params: DetectParams, max_distance: float = 5.0,
                  device: str | torch.device = "cuda"):
    """imgs0/imgs1 [B,H,W,3] (float in [0,1] or uint8) -> (n_matches
    0-d tensor, k0 [B,K,3], m1 [B,K,3]): k0 in the sampler's y order, m1 the
    keypoints of imgs1 that each row of k0 matched (rows of unmatched
    keypoints are padding). The model and params must already be on
    `device` (`load_params(..., device=)`): the step moves no weights."""
    dev = resolve_device(device)
    _check_weights(params, dev)
    imgs0 = torch.as_tensor(imgs0, device=dev)
    imgs1 = torch.as_tensor(imgs1, device=dev)
    d0, k0, v0 = extract(model, params, imgs0, detect_params)
    d1, k1, v1 = extract(model, params, imgs1, detect_params)
    nn01, ok = mutual_nn_match(d0, d1, v0, v1, max_distance)
    return ok.sum(), k0, take_rows(k1, nn01)


def superpoint_detect(model, imgs: torch.Tensor, dp: DetectParams):
    """SuperPoint forward + detection: imgs [B,H,W,3] -> (kpts [B,K,3],
    valid [B,K], desc_map [B,H/8,W/8,256])."""
    heat, desc = model(imgs)
    kpts, valid = detection_batch(heat, dp)
    return kpts, valid, desc


def covisible(kpts0, valid0, kpts1, valid1, Hs, Hinvs, width, height):
    """Validity masks of the keypoints whose warp lands inside the other
    image (reference MHA.py:33-39)."""
    _, _, va = warp_homography(kpts0, valid0, Hs, width, height)
    _, _, vb = warp_homography(kpts1, valid1, Hinvs, width, height)
    return va, vb


def match_pairs(matcher: str, kpts0, va, kpts1, vb, desc0, desc1, width,
                height, max_distance: float = 5.0,
                lightglue_params: dict | None = None):
    """(m_kpts0, m_kpts1, ok) for B pairs: brute force on descriptors
    sampled from the 1/8 maps, or LightGlue (desc_scale 8)."""
    if matcher == "brute_force":
        return brute_force_match(kpts0, va, kpts1, vb, desc0, desc1,
                                 max_distance)
    if matcher == "light_glue":
        return lightglue_match(lightglue_params, kpts0, va, kpts1, vb, desc0,
                               desc1, width, height, 8)
    raise ValueError(f"matcher must be one of {MATCHERS}, got {matcher!r}")


@torch.inference_mode()
def superpoint_mha_step(model, imgs0, imgs1, Hs, Hinvs,
                        detect_params: DetectParams,
                        generator: torch.Generator,
                        matcher: str = "brute_force",
                        lightglue_params: dict | None = None,
                        max_distance: float = 5.0, n_hyp: int = 512,
                        thresholds=(3.0, 5.0, 7.0),
                        device: str | torch.device = "cuda"):
    """B homography pairs imgs0/imgs1 [B,S,S,3] (float in [0,1] or uint8)
    with Hs / Hinvs [B,3,3] -> (hits [B, len(thresholds)], m_kpts0 [B,K,3],
    m_kpts1 [B,K,3], ok [B,K]). RANSAC's minimal samples come from
    `generator` (on `device`). The model, and LightGlue's params for
    matcher="light_glue", must already be on `device`."""
    dev = resolve_device(device)
    _check_weights(model.params, dev)
    if matcher == "light_glue":
        _check_weights(lightglue_params, dev)
    imgs0 = torch.as_tensor(imgs0, device=dev)
    imgs1 = torch.as_tensor(imgs1, device=dev)
    Hs = torch.as_tensor(Hs, dtype=torch.float32, device=dev)
    Hinvs = torch.as_tensor(Hinvs, dtype=torch.float32, device=dev)
    h, w = imgs0.shape[1], imgs0.shape[2]
    k0, v0, dm0 = superpoint_detect(model, imgs0, detect_params)
    k1, v1, dm1 = superpoint_detect(model, imgs1, detect_params)
    va, vb = covisible(k0, v0, k1, v1, Hs, Hinvs, w, h)
    m0, m1, ok = match_pairs(matcher, k0, va, k1, vb, dm0, dm1, w, h,
                             max_distance, lightglue_params)
    hits = mha_pair(m0, m1, ok, Hs, w, h, h, w, generator,
                    thresholds=thresholds, n_hyp=n_hyp)
    return hits, m0, m1, ok


@torch.inference_mode()
def lk_fundamental_step(model, params: dict, imgs0, imgs1, Fs,
                        generator: torch.Generator,
                        detect_params: DetectParams, lk: LKParams,
                        th: float = 3.0,
                        device: str | torch.device = "cuda"):
    """B consecutive-frame pairs imgs0/imgs1 [B,H,W,3] (float in [0,1] or
    uint8) with ground-truth Fs [B,3,3] (x1^T F x0 = 0) -> (metrics: dict
    of fundamental_error, fundamental_radio, fundamental_num, each [B];
    k0 [B,K,3]; valid [B,K]; tracked [B,K,2]). The keypoints of imgs0 are
    tracked into imgs1 from their own positions; the start jitter's angles
    come from `generator` (on `device`). The model and params must already
    be on `device`."""
    dev = resolve_device(device)
    _check_weights(params, dev)
    imgs0 = to_float_image(torch.as_tensor(imgs0, device=dev))
    imgs1 = to_float_image(torch.as_tensor(imgs1, device=dev))
    Fs = torch.as_tensor(Fs, dtype=torch.float32, device=dev)
    h, w = imgs0.shape[1], imgs0.shape[2]
    score, _ = model(imgs0)
    k0, v0 = detection_batch(score, detect_params)
    tracked, _ = optical_flow_batch(imgs0, imgs1, k0[:, :, 0:2],
                                    k0[:, :, 0:2], generator, lk)
    scale = torch.tensor([w - 1.0, h - 1.0], device=dev)
    out = fundamental_metrics(k0[:, :, 0:2] * scale, tracked * scale, v0,
                              Fs, th)
    return out, k0, v0, tracked


@torch.inference_mode()
def xfeat_auc_step(model, lightglue_params: dict, imgs0, imgs1, Ks,
                   poses01, detect_params: DetectParams,
                   generator: torch.Generator | None, n_hyp: int = 4096,
                   samples: torch.Tensor | None = None,
                   device: str | torch.device = "cuda"):
    """B SE3 pairs imgs0/imgs1 [B,S,S,3] (float in [0,1] or uint8; S a
    multiple of 32) with intrinsics Ks [B,3,3] (both cameras) and
    ground-truth poses01 [B,4,4] -> (errors [B] in degrees, 180 where
    the pose failed; n_inliers [B]; k0, k1 [B,K,3]; m0 [B,K]; match_mask
    [B,K]). RANSAC's minimal samples come from `generator` (on `device`),
    or are given as `samples` [B, n_hyp, 8]. The model and LightGlue's
    params (with `input_proj`) must already be on `device`."""
    dev = resolve_device(device)
    _check_weights(model.params, dev)
    _check_weights(lightglue_params, dev)
    imgs0 = torch.as_tensor(imgs0, device=dev)
    imgs1 = torch.as_tensor(imgs1, device=dev)
    Ks = torch.as_tensor(Ks, dtype=torch.float32, device=dev)
    poses01 = torch.as_tensor(poses01, dtype=torch.float32, device=dev)
    h, w = imgs0.shape[1], imgs0.shape[2]
    heat0, dm0 = model(imgs0)
    heat1, dm1 = model(imgs1)
    k0, v0 = detection_batch(heat0, detect_params)
    k1, v1 = detection_batch(heat1, detect_params)
    scale = torch.tensor([w - 1.0, h - 1.0], device=dev)
    p0, p1 = k0[..., 0:2] * scale, k1[..., 0:2] * scale
    m0, _, ok = lightglue_forward(
        lightglue_params, p0, v0, sample_descriptors_lg(p0, dm0, 8), p1, v1,
        sample_descriptors_lg(p1, dm1, 8))
    mp1 = take_rows(p1, m0.clamp_min(0))
    mask = ok & v0
    R, t, _, n_in, okp = estimate_pose_pair(p0, mp1, mask, Ks, Ks,
                                            generator, n_hyp=n_hyp,
                                            samples=samples)
    err = torch.where(okp, pose_error(R, t, poses01),
                      torch.full_like(okp, 180.0, dtype=torch.float32))
    return (err, torch.where(okp, n_in, torch.zeros_like(n_in)), k0, k1, m0,
            mask)
