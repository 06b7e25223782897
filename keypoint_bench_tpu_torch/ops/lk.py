"""Pyramidal Lucas-Kanade optical flow (counterpart of
keypoint_bench_tpu/ops/lk.py; reference utils/matcher.py:7-142).

  * Sobel-style gradients: grouped 3x3 cross-correlation with
    [[1,0,-1],[2,0,-2],[1,0,-1]] and its transpose, zero padding;
  * the pyramid average-pools the ORIGINAL image with kernel 2, 4, ...
    (levels [full, /2, /4] for levels=3), coarse to fine;
  * the start is jittered on a circle of radius `distance` and clipped to
    [10, S-10];
  * per level, `iterations` rounds of: bilinear win^2 patches of image 2
    and of its gradients at the current points, the 2x2 Gauss-Newton
    solve with a det > 1e-6 guard, pts -= G^-1 b. No early exit.

`_lk_level` is the plain PyTorch version of one level and of kernel F
(ops/cuda_lk.py, csrc/lk.cu): CPU tensors run it, CUDA tensors launch
the kernel. The window rule is the JAX package's XLA `_lk_level`: the
(win+1)^2 integer corner window of a point starts at floor(p) - win//2,
clamped so that it stays inside the field zero-padded by win+1.

All functions keep the JAX package's layout: images [..., H, W, C],
points [..., N, 2] as (x, y).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from keypoint_bench_tpu_torch.ops.cuda_lk import lk_level


@dataclasses.dataclass(frozen=True)
class LKParams:
    distance: float = 3.0
    win_size: int = 3
    levels: int = 1
    iterations: int = 40


def _gradients(img: torch.Tensor):
    """img [..., H, W, C] -> (dx, dy), same shape: per-channel 3x3
    cross-correlation with the reference's kernels, zero padding."""
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    kx = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]],
                      dtype=img.dtype, device=img.device)
    wx = kx[None, None].expand(c, 1, 3, 3)
    wy = kx.t()[None, None].expand(c, 1, 3, 3)
    dx = F.conv2d(x, wx, padding=1, groups=c)
    dy = F.conv2d(x, wy, padding=1, groups=c)
    return (dx.permute(0, 2, 3, 1).reshape(*lead, h, w, c),
            dy.permute(0, 2, 3, 1).reshape(*lead, h, w, c))


def _avg_pool_img(img: torch.Tensor, k: int) -> torch.Tensor:
    """img [..., H, W, C] -> [..., H//k, W//k, C]: k x k window sums
    (VALID), then one division by k*k."""
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.avg_pool2d(x, k, k, divisor_override=1) / (k * k)
    return y.permute(0, 2, 3, 1).reshape(*lead, h // k, w // k,
                                         c).contiguous()


def _window_bilinear(field_p: torch.Tensor, pts: torch.Tensor, win: int,
                     pad: int) -> torch.Tensor:
    """Bilinear win x win patches around pts from a field zero-padded by
    `pad` (>= win+1) on both spatial sides.

    field_p [..., Hp, Wp, C], pts [..., N, 2] in the UNPADDED field's
    pixels -> [..., N, win, win, C] (dy major). All taps of a point share
    one fractional offset, so their corners are one (win+1)^2 integer
    window; its start is clamped into the padded field, the fraction is
    not (the JAX package's rule). Taps off the image read the padding."""
    lead = field_p.shape[:-3]
    hp, wp, c = field_p.shape[-3:]
    n = pts.shape[-2]
    fp = field_p.reshape(-1, hp, wp, c)
    p = pts.reshape(-1, n, 2)
    wsz, half = win + 1, win // 2
    x0 = torch.floor(p[..., 0])
    y0 = torch.floor(p[..., 1])
    fx = (p[..., 0] - x0)[..., None, None, None]
    fy = (p[..., 1] - y0)[..., None, None, None]
    ys = torch.clamp(y0.long() - half + pad, 0, hp - wsz)
    xs = torch.clamp(x0.long() - half + pad, 0, wp - wsz)
    ar = torch.arange(wsz, device=fp.device)
    rows = (ys[..., None] + ar)[..., :, None]             # [B,N,wsz,1]
    cols = (xs[..., None] + ar)[..., None, :]             # [B,N,1,wsz]
    bidx = torch.arange(fp.shape[0], device=fp.device)[:, None, None, None]
    w = fp[bidx, rows, cols]                              # [B,N,wsz,wsz,C]
    out = ((1 - fy) * (1 - fx) * w[:, :, :-1, :-1]
           + (1 - fy) * fx * w[:, :, :-1, 1:]
           + fy * (1 - fx) * w[:, :, 1:, :-1]
           + fy * fx * w[:, :, 1:, 1:])
    return out.reshape(*lead, n, win, win, c)


def _pad_field(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, pad, pad, pad, pad))


def _lk_level(img1: torch.Tensor, img2: torch.Tensor, pts1: torch.Tensor,
              pts2: torch.Tensor, win: int, iterations: int) -> torch.Tensor:
    """One pyramid level, the plain version of kernel F: imgs
    [..., H, W, C], pts [..., N, 2] in this level's pixels -> tracked
    [..., N, 2]. One window gather per point and iteration."""
    img1 = img1.float()
    img2 = img2.float()
    c = img1.shape[-1]
    dx2, dy2 = _gradients(img2)
    pad = win + 1
    stacked_p = _pad_field(torch.cat([img2, dx2, dy2], dim=-1), pad)
    patch1 = _window_bilinear(_pad_field(img1, pad), pts1.float(), win, pad)
    pts = pts2.float()
    for _ in range(iterations):
        f = _window_bilinear(stacked_p, pts, win, pad)
        di = (patch1 - f[..., 0:c]).flatten(-3)
        jx = f[..., c:2 * c].flatten(-3)
        jy = f[..., 2 * c:3 * c].flatten(-3)
        g00 = (jx * jx).sum(-1)
        g01 = (jx * jy).sum(-1)
        g11 = (jy * jy).sum(-1)
        bx = (di * jx).sum(-1)
        by = (di * jy).sum(-1)
        det = g00 * g11 - g01 * g01
        ok = det > 1e-6
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det,
                                                    torch.ones_like(det)),
                              torch.zeros_like(det))
        ux = (g11 * bx - g01 * by) * inv_det
        uy = (-g01 * bx + g00 * by) * inv_det
        step = torch.stack([ux, uy], dim=-1)
        pts = pts - torch.where(ok[..., None], step, torch.zeros_like(step))
    return pts


def optical_flow_batch_from_angles(imgs1: torch.Tensor, imgs2: torch.Tensor,
                                   pts1: torch.Tensor, pts2: torch.Tensor,
                                   angles: torch.Tensor,
                                   params: LKParams = LKParams()):
    """Batched pyramidal LK with the start jitter's angles given: imgs
    [B, H, W, C], pts [B, N, >=2] in [0, 1], angles [B, N] in radians.
    Returns (tracked [B, N, 2] in [0, 1], err [B, N]: the distance in
    pixels from the unjittered pts2, capped at 8). Every level runs
    through ops/cuda_lk.lk_level: kernel F on CUDA tensors."""
    h, w = imgs1.shape[1], imgs1.shape[2]
    imgs1 = imgs1.float()
    imgs2 = imgs2.float()
    scale = torch.tensor([w - 1.0, h - 1.0], device=imgs1.device)
    p1 = pts1[..., 0:2].float() * scale
    p2 = pts2[..., 0:2].float() * scale
    angles = angles.to(p2)
    jitter = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    pr = p2 + jitter * params.distance
    pts_pre = torch.stack([pr[..., 0].clamp(10, w - 10),
                           pr[..., 1].clamp(10, h - 10)], dim=-1)
    pyr1, pyr2 = [imgs1], [imgs2]
    for i in range(params.levels - 1):
        k = 2 * (i + 1)
        pyr1.append(_avg_pool_img(imgs1, k))
        pyr2.append(_avg_pool_img(imgs2, k))
    for i in range(params.levels):
        lvl = params.levels - i - 1
        s = float(2 ** lvl)
        out = lk_level(pyr1[lvl], pyr2[lvl], p1 / s, pts_pre / s,
                       params.win_size, params.iterations)
        pts_pre = out * s
    err = torch.linalg.vector_norm(pts_pre - p2, dim=-1).clamp_max(8.0)
    return pts_pre / scale, err


def draw_angles(shape, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """The jitter's angles: standard normal draws times 6.28 (the
    reference's rule), from `generator` on `device`."""
    return torch.randn(shape, generator=generator, device=device) * 6.28


def optical_flow_batch(imgs1: torch.Tensor, imgs2: torch.Tensor,
                       pts1: torch.Tensor, pts2: torch.Tensor,
                       generator: torch.Generator,
                       params: LKParams = LKParams()):
    """`optical_flow_batch_from_angles` with the angles drawn from
    `generator` (on the images' device)."""
    angles = draw_angles(pts2.shape[:2], generator, imgs1.device)
    return optical_flow_batch_from_angles(imgs1, imgs2, pts1, pts2, angles,
                                          params)


def optical_flow(img1: torch.Tensor, img2: torch.Tensor, pts1: torch.Tensor,
                 pts2: torch.Tensor, generator: torch.Generator,
                 params: LKParams = LKParams()):
    """Track pts1 [N, >=2] (in [0, 1]) from img1 [H, W, C] into img2; pts2
    is the initial guess (the reference passes pts1 again). A batch of
    one. Returns (tracked [N, 2] in [0, 1], err [N])."""
    tracked, err = optical_flow_batch(img1[None], img2[None], pts1[None],
                                      pts2[None], generator, params)
    return tracked[0], err[0]


def optical_flow_cv(img0, img1, pts0, pts1, win_size: int = 15,
                    levels: int = 3):
    """cv2.calcOpticalFlowPyrLK on the host (reference utils/matcher.py:
    145-185): OPTFLOW_USE_INITIAL_FLOW; numpy in and out. Returns (tracked
    pts in [0, 1], status)."""
    import cv2
    h, w = img0.shape[0], img0.shape[1]
    scale = np.array([w - 1.0, h - 1.0], np.float32)
    p0 = (np.asarray(pts0[:, 0:2]) * scale).astype(np.float32)
    p1 = (np.asarray(pts1[:, 0:2]) * scale).astype(np.float32)
    u0 = (np.asarray(img0) * 255).astype(np.uint8)
    u1 = (np.asarray(img1) * 255).astype(np.uint8)
    lk = dict(winSize=(win_size, win_size), maxLevel=levels,
              flags=cv2.OPTFLOW_USE_INITIAL_FLOW,
              criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                        10, 0.03))
    tracked, status, _ = cv2.calcOpticalFlowPyrLK(u0, u1, p0, p1.copy(), **lk)
    return tracked / scale, status.reshape(-1)
