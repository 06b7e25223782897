"""Keypoint detection: iterative-fixpoint NMS -> border mask -> top-K
(counterpart of keypoint_bench_tpu/ops/detect.py).

`fast_nms` here is the plain PyTorch version of the fixpoint; on CUDA
tensors `detection_batch` runs it through kernel A (ops/cuda_nms.py).
`topk_select` is one stable sort (value descending, index ascending), the
exact result the JAX package's chunked candidate peel plus its fallback
guarantee. `detection_batch_fused` is the counterpart of the JAX package's
`_detection_batch_fused`: kernel A, then the per-chunk candidate peel
(kernel C on CUDA tensors, `peel_topk` here as its plain version), a stable
merge of the candidates and the chunk-cutoff safety test; it returns the
same keypoints as `detection_batch` by contract.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from keypoint_bench_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class DetectParams:
    """Extractor parameters (reference config/config.yaml extractor_params)."""

    nms_dist: int = 4
    threshold: float = 0.0
    border_dist: int = 8
    top_k: int = 300
    min_score: float = 0.0
    max_nms_iter: int = 30  # cap for the NMS fixpoint loop


def _local_max_mask(p: torch.Tensor, d: int) -> torch.Tensor:
    """[B,H,W] f32 -> bool mask: strictly greater than every window value
    at a row-major position before the centre, >= every value after, with
    zero padding (the reference's first-argmax tie split)."""
    h, w = p.shape[-2], p.shape[-1]
    padded = F.pad(p, (d, d, d, d), value=0.0)[:, None]       # [B,1,..]
    colmax = F.max_pool2d(padded, (1, 2 * d + 1), 1)          # [B,1,h+2d,w]
    rowswin = F.max_pool2d(colmax, (d, 1), 1)                 # [B,1,h+d+1,w]
    colwin = F.max_pool2d(padded, (1, d), 1)                  # [B,1,h+2d,w+d+1]
    before = torch.maximum(rowswin[:, 0, :h], colwin[:, 0, d:d + h, :w])
    after = torch.maximum(rowswin[:, 0, d + 1:d + 1 + h],
                          colwin[:, 0, d:d + h, d + 1:d + 1 + w])
    return (p > before) & (p >= after)


def _others_in_window(mask: torch.Tensor, d: int) -> torch.Tensor:
    """True where some OTHER local max lies in the (2d+1)^2 window."""
    m = mask.float()
    box = F.avg_pool2d(F.pad(m, (d, d, d, d))[:, None], 2 * d + 1, 1,
                       divisor_override=1)[:, 0]
    return (box - m) > 0


def fast_nms_rounds(probs: torch.Tensor, nms_dist: int = 4,
                    max_iter: int = 30, min_value: float = 0.0):
    """Plain fixpoint over [H,W] or [B,H,W] maps, each map stopping on its
    own. Returns (nms maps in probs' dtype, rounds run per map [B] i32).

    Runs in f32 and converts at the edges, which is value-exact for bf16 and
    f16 maps: comparisons preserve order and suppression writes min_value,
    rounded to the map's dtype first."""
    if nms_dist == 0:
        return probs, torch.zeros(probs.shape[:-2] or (1,), dtype=torch.int32,
                                  device=probs.device)
    squeeze = probs.dim() == 2
    p = (probs[None] if squeeze else probs).float()
    mv = torch.tensor(min_value, dtype=probs.dtype).float().item()
    d = nms_dist
    mask = _local_max_mask(p, d)
    count = mask.sum((1, 2))
    prev = torch.full_like(count, -1)
    rounds = torch.zeros_like(count, dtype=torch.int32)
    for _ in range(max_iter):
        active = count != prev
        if not bool(active.any()):
            break
        supp = _others_in_window(mask, d) & active[:, None, None]
        p = torch.where(supp, torch.full_like(p, mv), p)
        new_mask = _local_max_mask(p, d)
        mask = torch.where(active[:, None, None], new_mask, mask)
        prev = torch.where(active, count, prev)
        count = torch.where(active, new_mask.sum((1, 2)), count)
        rounds += active.int()
    out = p.to(probs.dtype)
    return (out[0] if squeeze else out), rounds


def fast_nms(probs: torch.Tensor, nms_dist: int = 4, max_iter: int = 30,
             min_value: float = 0.0) -> torch.Tensor:
    """Iterative local-max NMS (plain PyTorch): each round zeroes every
    pixel that has another local max in its window; rounds repeat until
    the local-max count is stable, at most `max_iter` times."""
    return fast_nms_rounds(probs, nms_dist, max_iter, min_value)[0]


def remove_border(probs: torch.Tensor, border_dist: int) -> torch.Tensor:
    """Zero a `border_dist`-wide band of [..., H, W] maps."""
    if border_dist <= 0:
        return probs
    out = torch.zeros_like(probs)
    b = border_dist
    out[..., b:probs.shape[-2] - b, b:probs.shape[-1] - b] = \
        probs[..., b:probs.shape[-2] - b, b:probs.shape[-1] - b]
    return out


def topk_select(flat: torch.Tensor, k: int):
    """Top-k along the last dim in (value desc, index asc) order."""
    neg, idx = torch.sort(-flat, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


def _kpts_from_topk(scores, idx, h: int, w: int, params: DetectParams):
    scores = scores.float()
    rows = torch.div(idx, w, rounding_mode="floor").float()
    cols = (idx % w).float()
    kpts = torch.stack([(cols + 0.5) / w, (rows + 0.5) / h, scores], dim=-1)
    valid = scores > params.threshold
    if params.min_score > 0:
        valid = valid & (scores > params.min_score)
    return kpts, valid


def detection_batch(score_maps: torch.Tensor,
                    params: DetectParams = DetectParams()):
    """[B,H,W] or [B,H,W,1] score maps -> (kpts [B,K,3] of (x, y, score)
    with x = (col+0.5)/W, y = (row+0.5)/H, sorted by descending score;
    valid [B,K] bool). On CUDA the NMS runs in kernel A."""
    from keypoint_bench_tpu_torch.ops import cuda_nms
    if score_maps.dim() == 4:
        score_maps = score_maps[..., 0]
    b, h, w = score_maps.shape
    with profiling.span("kbt.ops.detect"):
        with profiling.span("kbt.ops.detect.nms"):
            nms = cuda_nms.nms_fixpoint(score_maps, params.nms_dist,
                                        params.max_nms_iter)
        with profiling.span("kbt.ops.detect.topk"):
            flat = remove_border(nms, params.border_dist).reshape(
                b, h * w).float()
            scores, idx = topk_select(flat, min(params.top_k, h * w))
        return _kpts_from_topk(scores, idx, h, w, params)


def peel_topk(nms: torch.Tensor, border: int, per_chunk: int = 8):
    """Plain version of kernel C: the border-masked [B,H,W] map's top
    `per_chunk` values of every 128-column chunk of every row, by repeated
    (max, lowest column holding it, mask to -inf) rounds. Returns (vals
    [B,H,n_blk*per_chunk] f32, idx int32 global columns); candidate lane
    blk * per_chunk + j is round j of column block blk."""
    b, h, w = nms.shape
    n_blk = w // 128
    cur = remove_border(nms.float(), border).reshape(b, h, n_blk, 128)
    li = torch.arange(w, device=nms.device).reshape(n_blk, 128)
    vals, idxs = [], []
    for _ in range(per_chunk):
        m = cur.amax(-1, keepdim=True)
        idx = torch.where(cur == m, li, w).amin(-1, keepdim=True)
        vals.append(m)
        idxs.append(idx)
        cur = torch.where(li == idx, -torch.inf, cur)
    return (torch.cat(vals, -1).reshape(b, h, n_blk * per_chunk),
            torch.cat(idxs, -1).reshape(b, h, n_blk * per_chunk).int())


def detection_batch_fused(score_maps: torch.Tensor,
                          params: DetectParams = DetectParams(),
                          per_chunk: int = 8):
    """`detection_batch` through the fused candidate path: NMS fixpoint
    (kernel A) and border mask + per-chunk peel (kernel C), a stable merge
    of the H * n_blk * per_chunk candidates, and the exactness guard: if a
    chunk's last peeled value still reaches the merged cutoff (it may have
    held further top-k members or lower-index ties), every map takes the
    full stable sort instead. One host read per batch decides that.

    `top_k` above the number of candidates hands over to `detection_batch`
    (the JAX package's shape rule); w % 128 != 0, more than 128 candidates
    per row and nms_dist == 0 raise."""
    if score_maps.dim() == 4:
        score_maps = score_maps[..., 0]
    b, h, w = score_maps.shape
    k = min(params.top_k, h * w)
    if k > h * (w // 128) * per_chunk:
        return detection_batch(score_maps, params)
    vk, ik, _ = fused_topk(score_maps, params, k, per_chunk)
    return _kpts_from_topk(vk, ik, h, w, params)


def fused_topk(score_maps: torch.Tensor, params: DetectParams, k: int,
               per_chunk: int = 8):
    """The fused path's exact top-k of [B,H,W] maps: (values [B,k], flat
    indices [B,k], unsafe: whether the guard sent the batch to the full
    sort)."""
    from keypoint_bench_tpu_torch.ops import cuda_nms
    b, h, w = score_maps.shape
    nc = (w // 128) * per_chunk
    nms, v, i = cuda_nms.fast_nms_topk(score_maps, params.nms_dist,
                                       params.max_nms_iter,
                                       params.border_dist, per_chunk)
    vals = v.reshape(b, h * nc)
    gidx = (torch.arange(h, device=v.device)[None, :, None] * w
            + i.long()).reshape(b, h * nc)
    vk, pos = topk_select(vals, k)
    ik = gidx.gather(1, pos)
    cutoff = vk[:, k - 1]
    last = v[:, :, per_chunk - 1::per_chunk]              # [B, H, n_blk]
    unsafe = bool((last >= cutoff[:, None, None]).any())
    if unsafe:
        flat = remove_border(nms.float(), params.border_dist)
        vk, ik = topk_select(flat.reshape(b, h * w), k)
    return vk, ik, unsafe


def detection(score_map: torch.Tensor, params: DetectParams = DetectParams()):
    """One [H,W] or [H,W,1] map -> (kpts [K,3], valid [K])."""
    if score_map.dim() == 3:
        score_map = score_map[..., 0]
    kpts, valid = detection_batch(score_map[None], params)
    return kpts[0], valid[0]
