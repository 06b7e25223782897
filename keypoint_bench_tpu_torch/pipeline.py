"""The port's batched steps over image pairs.

`extract_match`: ALIKE-t extract + brute-force mutual-NN match (counterpart
of bench.py's default extract_match step, bench.py:594-622, at float32):
features -> detection_batch (NMS kernel A) -> y-ordered sparse descriptors
(sampler kernel B) -> mutual_nn_match (kernel D) -> take_rows.

`dense_extract_match`: any descriptor model's extract + brute-force
mutual-NN match from its dense descriptor map (counterpart of bench.py's
`pair_step` for `KBT_BENCH_MODEL`, bench.py:626-640, batched over the
pairs, at float32): forward -> detection_batch (kernel A) ->
sample_at_points of the dense map -> mutual_nn_match (kernel D) ->
take_rows. `dense_detect` is its forward + detection, the step of the
detector-only models (KeyNet, Harris, ORB, SIFT).

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

`vo_step`: batched monocular VO with optional windowed bundle adjustment
(counterpart of the JAX runner's `_run_vo_pipelined`, runner.py:969-1108,
and of the step of `bench_vo`, bench.py:356-405, at float32): detection
of every frame in chunks (`detect_frames`: kernel A, and kernel B for
sparse descriptors) -> shift-by-one pairing -> mutual_nn_match over all
pairs at once (kernel D) -> vo_pair_pose (essential RANSAC +
recoverPose) over all pairs -> chain_poses on the host; with ba_refine,
the world-to-camera chain -> chain_tracks -> refine_window (LM / Schur).

Every step runs in its model's precision, read from the weights: float32,
or bfloat16 (bench.py's default, `KBT_BENCH_PRECISION`) for weights from
`load_params(..., precision="bfloat16")`; the step casts no weights. In
bf16 the forwards run on bf16 weights (models/common.py) and
`extract_match` matches bf16 descriptors, as bench.py:616-618 does; every
other step matches the descriptors the reference's step matches, sampled
in f32. LightGlue's params stay f32 in both modes, as in the JAX runner.
"""
from __future__ import annotations

import numpy as np
import torch

from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.geometry.warp import warp_homography
from keypoint_bench_tpu_torch.models.common import to_float_image
from keypoint_bench_tpu_torch.models.lightglue import (lightglue_forward,
                                                       lightglue_match,
                                                       sample_descriptors_lg)
from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection_batch
from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
from keypoint_bench_tpu_torch.ops.lk import LKParams, optical_flow_batch
from keypoint_bench_tpu_torch.ops.matching import (brute_force_match,
                                                   mutual_nn_match, take_rows)
from keypoint_bench_tpu_torch.ops.sparse_desc import (
    alike_sparse_descriptors_cm_batch,
    alike_sparse_descriptors_cm_batch_yorder)
from keypoint_bench_tpu_torch.tasks.auc import estimate_pose_pair, pose_error
from keypoint_bench_tpu_torch.tasks.fundamental import fundamental_metrics
from keypoint_bench_tpu_torch.tasks.mha import mha_pair
from keypoint_bench_tpu_torch.tasks.vo import chain_poses, vo_pair_pose
from keypoint_bench_tpu_torch.tasks.vo_ba import (chain_tracks, chain_w2c,
                                                  refine_window)
from keypoint_bench_tpu_torch.utils import profiling

MATCHERS = ("brute_force", "light_glue")
_PRECISIONS = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _check_weights(params: dict, dev: torch.device) -> str:
    """The precision of `params`: "bfloat16" where its weights (rank >= 2)
    are bf16, else "float32" (a model configured by `model_params`, such
    as Harris, holds none). Raises unless its tensors are on `dev` and its
    weights all in one of the two dtypes."""
    tensors = [v for v in params.values() if isinstance(v, torch.Tensor)]
    if not tensors:
        return "float32"
    w_dev = tensors[0].device
    if w_dev.type != dev.type or (dev.index is not None
                                  and w_dev.index != dev.index):
        raise ValueError(f"params are on {w_dev}, the step runs on {dev}: "
                         f"load them with load_params(..., device=)")
    dtypes = {v.dtype for v in tensors if v.dim() >= 2}
    if len(dtypes) > 1 or not dtypes <= _PRECISIONS.keys():
        raise ValueError(f"a step takes weights all in float32 or all in "
                         f"bfloat16, got {sorted(map(str, dtypes))}: load "
                         f"them with load_params(..., precision=)")
    return _PRECISIONS[dtypes.pop()] if dtypes else "float32"


def _check_lightglue(params: dict, dev: torch.device):
    """LightGlue's params stay f32 in both modes, as in the JAX runner."""
    if _check_weights(params, dev) != "float32":
        raise ValueError("LightGlue's params stay float32")


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
    `device` (`load_params(..., device=)`): the step moves and casts no
    weights. With bf16 weights the f32 descriptors are rounded to bf16
    for the match (bench.py:616-618)."""
    dev = resolve_device(device)
    precision = _check_weights(params, dev)
    imgs0 = torch.as_tensor(imgs0, device=dev)
    imgs1 = torch.as_tensor(imgs1, device=dev)
    d0, k0, v0 = extract(model, params, imgs0, detect_params)
    d1, k1, v1 = extract(model, params, imgs1, detect_params)
    m1, ok = match_sparse(k1, d0, d1, v0, v1, max_distance,
                          torch.bfloat16 if precision == "bfloat16" else None)
    return ok.sum(), k0, m1


def match_sparse(k1, d0, d1, v0, v1, max_distance: float,
                 match_dtype=None):
    """Mutual-NN match (kernel D on CUDA) of keypoint descriptors d0 / d1
    [B,K,D], in `match_dtype` where given (bf16 weights match bf16
    descriptors) -> (m1 [B,K,3], the keypoints k1 that each row of d0
    matched; ok [B,K])."""
    if match_dtype is not None:
        d0, d1 = d0.to(match_dtype), d1.to(match_dtype)
    nn01, ok = mutual_nn_match(d0, d1, v0, v1, max_distance)
    return take_rows(k1, nn01), ok


def _images(imgs, dev: torch.device) -> torch.Tensor:
    """imgs [B,H,W,3] on `dev`; H and W must be multiples of 32 (the
    runner's _crop32), which every model's strides divide."""
    imgs = torch.as_tensor(imgs, device=dev)
    if imgs.dim() != 4 or imgs.shape[1] % 32 or imgs.shape[2] % 32:
        raise ValueError(f"expected [B,H,W,3] images with H and W multiples "
                         f"of 32, got {tuple(imgs.shape)}")
    return imgs


@torch.inference_mode()
def dense_detect(model, imgs, detect_params: DetectParams,
                 device: str | torch.device = "cuda"):
    """imgs [B,H,W,3] (float in [0,1] or uint8; H, W multiples of 32) ->
    (kpts [B,K,3], valid [B,K], desc map [B,H/s,W/s,D] or None for a
    detector-only model). The model must already be on `device`."""
    dev = resolve_device(device)
    _check_weights(model.params, dev)
    score, desc = model(_images(imgs, dev))
    kpts, valid = detection_batch(score, detect_params)
    return kpts, valid, desc


@torch.inference_mode()
def dense_extract_match(model, imgs0, imgs1, detect_params: DetectParams,
                        max_distance: float = 5.0,
                        device: str | torch.device = "cuda"):
    """B pairs imgs0/imgs1 [B,H,W,3] (float in [0,1] or uint8; H, W
    multiples of 32) -> (n_matches 0-d tensor, k0 [B,K,3], m1 [B,K,3]), as
    `extract_match` returns them: m1 holds the keypoints of imgs1 that
    each row of k0 matched (rows of unmatched keypoints are padding).
    Descriptors are sampled in f32 from the model's dense map at the
    keypoints (of a bf16 map too, as bench.py's dense pair step samples
    them); a detector-only model raises ValueError (time it with
    `dense_detect`)."""
    k0, v0, dm0 = dense_detect(model, imgs0, detect_params, device)
    if dm0 is None:
        raise ValueError(f"dense_extract_match matches descriptors; "
                         f"{type(model).__name__} is a detector without "
                         f"them (use dense_detect)")
    k1, v1, dm1 = dense_detect(model, imgs1, detect_params, device)
    nn01, ok = mutual_nn_match(sample_at_points(dm0, k0),
                               sample_at_points(dm1, k1), v0, v1,
                               max_distance)
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
    `generator` (on `device`). The model, and LightGlue's f32 params for
    matcher="light_glue", must already be on `device`."""
    dev = resolve_device(device)
    _check_weights(model.params, dev)
    if matcher == "light_glue":
        _check_lightglue(lightglue_params, dev)
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
    or are given as `samples` [B, n_hyp, 8]. The model, and
    LightGlue's f32 params (with `input_proj`), must already be on
    `device`. The descriptor maps go to LightGlue in f32 (bench.py:284)."""
    dev = resolve_device(device)
    _check_weights(model.params, dev)
    _check_lightglue(lightglue_params, dev)
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
        lightglue_params, p0, v0, sample_descriptors_lg(p0, dm0.float(), 8),
        p1, v1, sample_descriptors_lg(p1, dm1.float(), 8))
    mp1 = take_rows(p1, m0.clamp_min(0))
    mask = ok & v0
    R, t, _, n_in, okp = estimate_pose_pair(p0, mp1, mask, Ks, Ks,
                                            generator, n_hyp=n_hyp,
                                            samples=samples)
    err = torch.where(okp, pose_error(R, t, poses01),
                      torch.full_like(okp, 180.0, dtype=torch.float32))
    return (err, torch.where(okp, n_in, torch.zeros_like(n_in)), k0, k1, m0,
            mask)


def detect_frames(model, frames, dp: DetectParams, device: torch.device,
                  sparse: bool = False, chunk: int = 8):
    """Batched detection over equal-shape frames [n,H,W,3] (float in
    [0,1] or uint8; numpy, or a tensor on `device`, where the model is):
    one batched
    forward + detection_batch per chunk of `chunk` frames, each chunk moved
    to the device as it is (uint8 frames are normalized there). Returns
    stacked (scores [n,H,W,1], descs, kpts [n,K,3], valids [n,K]), equal
    to detecting frame by frame. descs is the dense map [n,H/s,W/s,D], or
    with sparse=True (ALIKE) the per-keypoint vectors [n,K,64] from the
    sparse sampler (kernel B on CUDA), with no dense map built; None for
    a detector-only model."""
    parts = []
    for i0 in range(0, len(frames), chunk):
        imgs = torch.as_tensor(frames[i0:i0 + chunk], device=device)
        if sparse:
            h, w = imgs.shape[1], imgs.shape[2]
            with profiling.span("kbt.models.forward"):
                score, feats = model.feats(imgs)
            kpts, valid = detection_batch(score, dp)
            with profiling.span("kbt.ops.describe"):
                desc = alike_sparse_descriptors_cm_batch(model.params, feats,
                                                         kpts, h, w)
        else:
            with profiling.span("kbt.models.forward"):
                score, desc = model(imgs)
            kpts, valid = detection_batch(score, dp)
        parts.append((score, desc, kpts, valid))
    return tuple(None if parts[0][j] is None
                 else torch.cat([p[j] for p in parts]) for j in range(4))


@torch.inference_mode()
def vo_step(model, frames, K, scales, detect_params: DetectParams,
            generator: torch.Generator | None, max_distance: float = 5.0,
            n_hyp: int = 4096, ba_refine: bool = False,
            samples: torch.Tensor | None = None, sparse: bool = True,
            device: str | torch.device = "cuda", mesh=None):
    """Monocular VO over T consecutive frames [T,H,W,3] (float in [0,1] or
    uint8) with intrinsics K [3,3] and per-frame ground-truth scales [T]
    (||t_gt_i - t_gt_{i-1}||, 0 for frame 0). Frame i pairs with frame
    i-1, and frame 0 with itself. The pair solve is single-focal (fx, cx,
    cy; `vo_pair_pose`); BA projects with fx and fy. Descriptors are
    ALIKE's sparse ones with `sparse` (the model must have `feats`), else
    sampled from the dense map. RANSAC's minimal samples come from
    `generator` (on `device`), or are given as `samples` [T, n_hyp, 8].
    The model must already be on `device`; the f32 descriptors are
    matched in f32 in both precisions, as the JAX runner's
    `_run_vo_pipelined` matches them.

    Returns a dict: the relative poses `R_rel` [T,3,3], `t_rel` [T,3],
    `n_inliers` [T], `ok` [T]; the detections `kpts` [T,K,3], `valid`
    [T,K]; the matches `nn01` [T,K] (into frame i's keypoints) and
    `match_mask` [T,K] (tensors on `device`); the chained `R_est`
    [T+1,3,3], `t_est` [T+1,3,1] (numpy). With ba_refine, when the window
    has enough tracks, also `ba_R_w2c`, `ba_t_w2c`, `ba_points` (numpy),
    `ba_reproj_before`, `ba_reproj_after` and `ba_tracks` (the runner's
    keys); with `mesh`, the window refines through the distributed Schur
    solver over its data ranks (`refine_window(mesh=...)`)."""
    dev = resolve_device(device)
    _check_weights(model.params, dev)
    frames = torch.as_tensor(frames, device=dev)
    K = np.asarray(K, np.float32)
    h, w = frames.shape[1], frames.shape[2]
    _, descs, kpts, valid = detect_frames(model, frames, detect_params, dev,
                                          sparse)
    if descs is None:
        raise ValueError(f"vo_step matches descriptors; "
                         f"{type(model).__name__} is a detector without them")
    if not sparse:
        descs = sample_at_points(descs, kpts)

    def shift1(x):
        """The previous frame's operand of every frame (frame 0 pairs
        with itself)."""
        return torch.cat([x[:1], x[:-1]])

    nn01, ok = mutual_nn_match(shift1(descs), descs, shift1(valid), valid,
                               max_distance)
    scale = torch.tensor([w - 1.0, h - 1.0], device=dev)
    R, t, n_in, okp = vo_pair_pose(
        shift1(kpts)[..., 0:2] * scale, take_rows(kpts, nn01)[..., 0:2]
        * scale, ok, K[0, 0], K[0, 2], K[1, 2], generator, n_hyp,
        samples=samples)
    rel_R, rel_t, ok_np = R.cpu().numpy(), t.cpu().numpy(), okp.cpu().numpy()
    scales = np.asarray(scales, np.float64)
    R_est, t_est = chain_poses(rel_R, rel_t, ok_np, scales)
    out = {"R_rel": R, "t_rel": t, "n_inliers": n_in, "ok": okp,
           "kpts": kpts, "valid": valid, "nn01": nn01, "match_mask": ok,
           "R_est": R_est, "t_est": t_est}
    if not ba_refine:
        return out
    R_w2c, t_w2c = chain_w2c(rel_R, rel_t, ok_np, scales)
    tracks = chain_tracks(nn01.cpu().numpy(), ok.cpu().numpy())
    kpts_px = (kpts[..., 0:2] * scale).cpu().numpy()
    ref = refine_window(kpts_px, tracks, R_w2c, t_w2c, K, mesh=mesh,
                        device=dev)
    if ref is not None:
        out.update(zip(("ba_R_w2c", "ba_t_w2c", "ba_points",
                        "ba_reproj_before", "ba_reproj_after"), ref))
        out["ba_tracks"] = len(tracks)
    return out
