"""The plain reference of the benchmark's two tasks over one batch of
pairs, in two stages that meet at the keypoints and matches:

- `front`: from the batch's images alone, each image's keypoints (and
  NMS rounds) and the pairs' mutual-NN matches;
- `tail`: from keypoints and matches (the reference's own, or the ones
  the measured program produced in its timed step) and the batch's
  geometry and RANSAC seeds, the per-pair outputs the measured step
  returns.
"""
from __future__ import annotations

import torch

from port_bench.reference import detect as D
from port_bench.reference import geometry as G
from port_bench.reference.models import FORWARDS, image_nchw

BLOCK = 8      # images a forward: keeps the dense maps of a batch small


def features(config: dict, weights: dict, imgs: torch.Tensor):
    """uint8 images [n,H,W,3] -> (kpts [n,K,3], valid [n,K], descriptors
    at the keypoints [n,K,C], NMS rounds [n])."""
    fwd = FORWARDS[config["model"]]
    out = []
    for i in range(0, len(imgs), BLOCK):
        score, dmap = fwd(weights, image_nchw(imgs[i:i + BLOCK]))
        k, v, r = D.detect(score, config["extractor"])
        out.append((k, v, D.descriptors_at(dmap, k), r))
        del score, dmap
    return tuple(torch.cat(parts) for parts in zip(*out))


def _covisible(state: dict, batch: dict):
    """Both sides' keypoints warped into the other image: (a0, a01, va,
    b0, b10, vb) of the homography pairs."""
    h, w = batch["imgs0"].shape[1:3]
    return (*G.warp_homography(state["k0"], state["v0"], batch["H"], w, h),
            *G.warp_homography(state["k1"], state["v1"], batch["Hinv"], w,
                               h))


def front(config: dict, weights: dict, task: str, batch: dict) -> dict:
    """Keypoints k0/k1 [B,K,3] with valid v0/v1, NMS rounds [2B] (side 0
    first), and matches: m0 (= k0), m1 the k1 rows each row of k0
    matched, ok [B,K]. Repeatability matches the covisible keypoints,
    AUC all of them."""
    k0, v0, d0, r0 = features(config, weights, batch["imgs0"])
    k1, v1, d1, r1 = features(config, weights, batch["imgs1"])
    state = {"k0": k0, "v0": v0, "k1": k1, "v1": v1,
             "rounds": torch.cat([r0, r1])}
    mv0, mv1 = v0, v1
    if task == "repeatability":
        _, _, mv0, _, _, mv1 = _covisible(state, batch)
    nn01, ok = D.mutual_nn(d0, d1, mv0, mv1,
                           float(config["matcher"]["max_distance"]))
    state.update(m0=k0, m1=k1.gather(1, nn01[..., None].expand(-1, -1, 3)),
                 ok=ok)
    return state


def _pixels(state: dict, batch: dict):
    h, w = batch["imgs0"].shape[1:3]
    s = torch.tensor([w - 1.0, h - 1.0], device=state["m0"].device)
    return state["m0"][..., 0:2] * s, state["m1"][..., 0:2] * s


def repeatability_tail(traffic: dict, batch: dict, state: dict) -> dict:
    """-> {repeatability, mean_error, num_feat, gt_num,
    homography_inliers} each [B]."""
    a0, a01, va, b0, b10, vb = _covisible(state, batch)
    rep, err, nf, gt = G.repeatability(state["v0"], state["v1"], a0, a01,
                                       va, b0, b10, vb, batch["scale"],
                                       float(traffic["th"]))
    p0, p1 = _pixels(state, batch)
    inl = G.ransac_h_inliers(p0, p1, state["ok"], G.minimal_samples(
        state["ok"], batch["seeds"], int(traffic["ransac_hypotheses"]), 4))
    return {"repeatability": rep, "mean_error": err,
            "num_feat": nf.float(), "gt_num": gt.float(),
            "homography_inliers": inl}


def auc_tail(traffic: dict, batch: dict, state: dict) -> dict:
    """-> {pose_error (degrees, 180 where the pose failed), inliers (0
    there)} each [B]."""
    p0, p1 = _pixels(state, batch)
    R, t, n_in, okp = G.relative_pose(
        p0, p1, state["ok"], batch["K0"], batch["K1"], batch["seeds"],
        int(traffic["ransac_hypotheses"]))
    err = torch.where(okp, G.pose_error(R, t, batch["pose01"]),
                      torch.full_like(n_in, 180.0, dtype=torch.float32))
    return {"pose_error": err,
            "inliers": torch.where(okp, n_in, torch.zeros_like(n_in)).float()}


TAILS = {"repeatability": repeatability_tail, "auc": auc_tail}
