"""Masked fixed-K keypoint warps: homography and SE3 with depth
(counterpart of keypoint_bench_tpu/geometry/warp.py).

Homography: pixels are p01 * (w-1, h-1); a warped point is valid iff it
lands inside [0, w-1] x [0, h-1]. SE3: pixels are p01 * (W, H); bilinear
depth with a 10-px border and the valid-corner and valid-depth rules, the
COLMAP +0.5 offset, unproject -> pose01 -> project, and the occlusion test
|z01 - z1| < 0.05. Every function keeps the K rows and returns a validity
mask (no compaction), and takes leading batch dimensions.
"""
from __future__ import annotations

import torch


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def warp_homography(kpts01: torch.Tensor, valid: torch.Tensor,
                    H: torch.Tensor, width, height):
    """kpts01 [..., K, >=2] normalized (x, y); H [..., 3, 3]; width/height
    of the image H is expressed in. Returns (kpts0 [..., K, 2], kpts01w
    [..., K, 2], valid [..., K]), all normalized by (w-1, h-1)."""
    H = _f32(H, kpts01.device)
    scale = torch.tensor([float(width) - 1.0, float(height) - 1.0],
                         dtype=torch.float32, device=kpts01.device)
    p = kpts01[..., 0:2] * scale
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    q = ph @ H.transpose(-1, -2)
    qz = q[..., 2:3]
    safe = torch.where(qz.abs() > 1e-12, qz, torch.full_like(qz, 1e-12))
    q = q[..., 0:2] / safe
    inb = ((q[..., 0] >= 0) & (q[..., 0] <= scale[0])
           & (q[..., 1] >= 0) & (q[..., 1] <= scale[1]))
    return p / scale, q / scale, valid & inb


def _interp_depth(p: torch.Tensor, depth: torch.Tensor, border: int = 10):
    """Bilinear depth at pixel coordinates p [..., K, 2] (x, y) of depth
    [..., H, W], with the reference's rules (utils/projection.py:269-371):
    all four corners at least `border` px inside, all four depths > 0.
    Returns (z [..., K], valid [..., K])."""
    h, w = depth.shape[-2], depth.shape[-1]
    i, j = p[..., 1], p[..., 0]
    i0, j0 = torch.floor(i), torch.floor(j)
    i1, j1 = torch.ceil(i), torch.ceil(j)
    valid_corners = ((i0 >= border) & (j0 >= border)
                     & (i1 < h - border) & (j1 < w - border))
    i0c, i1c = (x.clamp(0, h - 1).long() for x in (i0, i1))
    j0c, j1c = (x.clamp(0, w - 1).long() for x in (j0, j1))
    d = depth.flatten(-2)
    d00, d01, d10, d11 = (d.gather(-1, a * w + b) for a, b in (
        (i0c, j0c), (i0c, j1c), (i1c, j0c), (i1c, j1c)))
    valid_depth = (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
    di, dj = i - i0, j - j0
    z = ((1 - di) * (1 - dj) * d00 + (1 - di) * dj * d01
         + di * (1 - dj) * d10 + di * dj * d11)
    return z, valid_corners & valid_depth


def _xy_offset(bbox: torch.Tensor) -> torch.Tensor:
    """A (row, col) crop offset [..., 2] as the (x, y) shift [..., 1, 2]."""
    return torch.stack([bbox[..., 1], bbox[..., 0]], dim=-1)[..., None, :]


def warp_se3(kpts01: torch.Tensor, valid: torch.Tensor, pose01, bbox0,
             bbox1, depth0, depth1, K0, K1):
    """SE3 warp with depth (reference utils/projection.py:194-266).

    kpts01 [..., K, >=2] normalized (x, y); pose01 [..., 4, 4]; bbox
    [..., 2] (row, col) crop offsets; depth [..., H, W]; K [..., 3, 3].
    Returns (kpts0 [..., K, 2], kpts01w [..., K, 2], valid [..., K]),
    normalized by (W, H)."""
    dev = kpts01.device
    pose01, bbox0, bbox1, depth0, depth1, K0, K1 = (
        _f32(x, dev) for x in (pose01, bbox0, bbox1, depth0, depth1, K0, K1))
    scale0 = torch.tensor([depth0.shape[-1], depth0.shape[-2]],
                          dtype=torch.float32, device=dev)
    scale1 = torch.tensor([depth1.shape[-1], depth1.shape[-2]],
                          dtype=torch.float32, device=dev)
    p0 = kpts01[..., 0:2] * scale0
    z0, v0 = _interp_depth(p0, depth0)

    # COLMAP convention: the crop offset (col, row) plus 0.5
    bp0 = p0 + _xy_offset(bbox0) + 0.5
    xy1 = torch.cat([bp0 * z0[..., None], z0[..., None]], dim=-1)
    pts3d0 = xy1 @ torch.linalg.inv(K0).transpose(-1, -2)
    pts3d0h = torch.cat([pts3d0, torch.ones_like(z0[..., None])], dim=-1)
    pts3d1 = (pts3d0h @ pose01.transpose(-1, -2))[..., 0:3]

    zuv1 = pts3d1 @ K1.transpose(-1, -2)
    zz = zuv1[..., 2:3]
    zsafe = torch.where(zz.abs() > 1e-12, zz, torch.full_like(zz, 1e-12))
    buv1 = zuv1[..., 0:2] / zsafe
    uv1 = buv1 - _xy_offset(bbox1) - 0.5

    z1i, v1 = _interp_depth(uv1, depth1)
    occl_ok = (zuv1[..., 2] - z1i).abs() < 0.05
    out_valid = valid & v0 & v1 & occl_ok & (z0 > 0)
    return p0 / scale0, uv1 / scale1, out_valid


def dense_grid(h: int, w: int) -> torch.Tensor:
    """Pixel-centre grid [H*W, 2] of (x, y) over the image, normalized to
    [0, 1] (reference utils/projection.py:170-175)."""
    xs = torch.linspace(1 / w / 2, 1 - 1 / w / 2, w)
    ys = torch.linspace(1 / h / 2, 1 - 1 / h / 2, h)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)


def warp_dense(h: int, w: int, warp_params: dict):
    """Warp every pixel centre (reference utils/projection.py:170-182).
    Returns (pts0 [HW, 2], pts01 [HW, 2], valid [HW])."""
    pts = dense_grid(h, w)
    return warp_points(pts, torch.ones(pts.shape[0], dtype=torch.bool),
                       warp_params)


def warp_points(kpts: torch.Tensor, valid: torch.Tensor, warp_params: dict):
    """Mode dispatch (reference utils/projection.py:185-192)."""
    mode = warp_params["mode"]
    if mode == "homo":
        return warp_homography(kpts, valid, warp_params["homography_matrix"],
                               warp_params["width"], warp_params["height"])
    if mode == "se3":
        return warp_se3(kpts, valid, warp_params["pose01"],
                        warp_params["bbox0"], warp_params["bbox1"],
                        warp_params["depth0"], warp_params["depth1"],
                        warp_params["intrinsics0"],
                        warp_params["intrinsics1"])
    raise ValueError(f"unknown warp mode {mode!r}")
