"""Plain keypoint detection, descriptor lookup and mutual-NN matching.

Detection: the iterative local-max NMS fixpoint (each round zeroes every
pixel with another local maximum in its (2d+1)^2 window; rounds repeat
until a map's count of local maxima is stable, at most 30), a zeroed
border band, then the top k by (score descending, index ascending).
A keypoint is (x, y, score) with x = (col + 0.5) / W, y = (row + 0.5) / H,
valid where its score is above the threshold (and min_score).

Descriptors are read from a dense map by bilinear interpolation at
p * (S - 1), zero outside (grid_sample, align_corners=True). Matching is
mutual nearest neighbours on squared distances, first index on ties,
strictly below max_distance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _local_max_mask(p: torch.Tensor, d: int) -> torch.Tensor:
    """Strictly above every window value before the centre (row major),
    at least every value after it; zero padding."""
    h, w = p.shape[-2:]
    padded = F.pad(p, (d, d, d, d), value=0.0)[:, None]
    colmax = F.max_pool2d(padded, (1, 2 * d + 1), 1)
    rowswin = F.max_pool2d(colmax, (d, 1), 1)
    colwin = F.max_pool2d(padded, (1, d), 1)
    before = torch.maximum(rowswin[:, 0, :h], colwin[:, 0, d:d + h, :w])
    after = torch.maximum(rowswin[:, 0, d + 1:d + 1 + h],
                          colwin[:, 0, d:d + h, d + 1:d + 1 + w])
    return (p > before) & (p >= after)


def _others_in_window(mask: torch.Tensor, d: int) -> torch.Tensor:
    m = mask.float()
    box = F.avg_pool2d(F.pad(m, (d, d, d, d))[:, None], 2 * d + 1, 1,
                       divisor_override=1)[:, 0]
    return (box - m) > 0


def nms(p: torch.Tensor, d: int, max_iter: int = 30):
    """[B,H,W] f32 -> (suppressed maps, rounds run per map [B])."""
    mask = _local_max_mask(p, d)
    count = mask.sum((1, 2))
    prev = torch.full_like(count, -1)
    rounds = torch.zeros_like(count)
    for _ in range(max_iter):
        active = count != prev
        if not bool(active.any()):
            break
        supp = _others_in_window(mask, d) & active[:, None, None]
        p = torch.where(supp, torch.zeros_like(p), p)
        new_mask = _local_max_mask(p, d)
        mask = torch.where(active[:, None, None], new_mask, mask)
        prev = torch.where(active, count, prev)
        count = torch.where(active, new_mask.sum((1, 2)), count)
        rounds += active.long()
    return p, rounds


def detect(score: torch.Tensor, ex: dict):
    """score [B,H,W] -> (kpts [B,K,3], valid [B,K], NMS rounds [B])."""
    b, h, w = score.shape
    p, rounds = nms(score.float(), int(ex["nms_dist"]))
    bd = int(ex["border_dist"])
    kept = torch.zeros_like(p)
    kept[:, bd:h - bd, bd:w - bd] = p[:, bd:h - bd, bd:w - bd]
    neg, idx = torch.sort(-kept.reshape(b, h * w), dim=-1, stable=True)
    k = min(int(ex["top_k"]), h * w)
    scores, idx = -neg[:, :k], idx[:, :k]
    rows = torch.div(idx, w, rounding_mode="floor").float()
    cols = (idx % w).float()
    kpts = torch.stack([(cols + 0.5) / w, (rows + 0.5) / h, scores], -1)
    valid = scores > float(ex["threshold"])
    if float(ex["min_score"]) > 0:
        valid &= scores > float(ex["min_score"])
    return kpts, valid, rounds


def descriptors_at(dmap: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """dmap [B,C,H,W], kpts [B,K,>=2] -> [B,K,C] (align-corners bilinear)."""
    grid = (kpts[:, :, None, 0:2] * 2.0 - 1.0).float()
    out = F.grid_sample(dmap, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[..., 0].transpose(1, 2)


def mutual_nn(d0, d1, v0, v1, max_distance: float):
    """(nn01 [B,M], ok [B,M]) on squared distances |a|^2 + |b|^2 - 2ab."""
    a2 = (d0 * d0).sum(-1, keepdim=True)
    b2 = (d1 * d1).sum(-1, keepdim=True)
    dist = torch.clamp_min(a2 + b2.transpose(1, 2)
                           - 2.0 * (d0 @ d1.transpose(1, 2)), 0.0)
    big = torch.full_like(dist, 1e30)
    dist = torch.where(v0[:, :, None] & v1[:, None, :], dist, big)
    nn01 = dist.argmin(-1)
    nn10 = dist.argmin(-2)
    rows = torch.arange(dist.shape[1], device=dist.device)
    mutual = nn10.gather(1, nn01) == rows
    best = dist.gather(2, nn01[..., None])[..., 0]
    ok = mutual & v0 & (best < max_distance ** 2) & (best < 1e30)
    return nn01, ok
