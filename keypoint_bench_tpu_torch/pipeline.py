"""The port's main path: ALIKE-t extract + brute-force mutual-NN match over
a batch of image pairs (counterpart of bench.py's default extract_match
step, bench.py:594-622, at float32).

features -> detection_batch (NMS kernel A) -> y-ordered sparse
descriptors (sampler kernel B) -> mutual_nn_match -> take_rows.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection_batch
from keypoint_bench_tpu_torch.ops.matching import mutual_nn_match, take_rows
from keypoint_bench_tpu_torch.ops.sparse_desc import \
    alike_sparse_descriptors_cm_batch_yorder


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
    w_dev = next(iter(params.values())).device
    if w_dev.type != dev.type or (dev.index is not None
                                  and w_dev.index != dev.index):
        raise ValueError(f"params are on {w_dev}, the step runs on {dev}: "
                         f"load them with load_params(..., device=)")
    imgs0 = torch.as_tensor(imgs0, device=dev)
    imgs1 = torch.as_tensor(imgs1, device=dev)
    d0, k0, v0 = extract(model, params, imgs0, detect_params)
    d1, k1, v1 = extract(model, params, imgs1, detect_params)
    nn01, ok = mutual_nn_match(d0, d1, v0, v1, max_distance)
    return ok.sum(), k0, take_rows(k1, nn01)
