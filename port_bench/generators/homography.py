"""Homography pairs: a copy of the port's
`datasets/synthetic.SyntheticHomographyDataset` (its `_texture` and
`_warp_image`), numpy only, kept here so that an edit of the
program cannot move the benchmark's traffic.

A pair is a blocky smoothed texture and its warp under a mild random
perspective about the centre (rotation +-0.1 rad, scale 0.9-1.1, shift
+-20 px). Pair `idx` of a pool draws from its own generator seeded with
(pool entropy, idx), so a pool is the same whatever process renders it.
"""
from __future__ import annotations

import numpy as np


def texture(h: int, w: int, rng, blocks: int = 8) -> np.ndarray:
    base = rng.random((h // blocks, w // blocks))
    img = np.kron(base, np.ones((blocks, blocks)))
    # light smoothing for gradient structure: scipy's convolve2d with a
    # 3 x 3 box, mode "same", boundary "symm", as a sum of shifted views
    pad = np.pad(img, 1, mode="symmetric")
    img = sum(pad[i:i + img.shape[0], j:j + img.shape[1]]
              for i in range(3) for j in range(3)) / 9.0
    rgb = np.stack([img, np.roll(img, 3, 0), np.roll(img, 3, 1)], axis=-1)
    return rgb.astype("float32")


def warp_image(img: np.ndarray, H_inv: np.ndarray) -> np.ndarray:
    """Inverse warp with bilinear sampling; zero outside the source."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], axis=1)
    src = pts @ H_inv.T
    src = src[:, :2] / src[:, 2:]
    x = src[:, 0].reshape(h, w)
    y = src[:, 1].reshape(h, w)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    fx = np.clip(x - x0, 0, 1)[..., None]
    fy = np.clip(y - y0, 0, 1)[..., None]
    out = ((1 - fy) * (1 - fx) * img[y0, x0] + (1 - fy) * fx * img[y0, x0 + 1]
           + fy * (1 - fx) * img[y0 + 1, x0] + fy * fx * img[y0 + 1, x0 + 1])
    inb = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))[..., None]
    return (out * inb).astype("float32")


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8, rounded; both sides read these bytes."""
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def make_pair(entropy: int, idx: int, traffic: dict) -> dict:
    """Pair `idx`: uint8 images [S,S,3], H (0 -> 1) and its inverse."""
    rng = np.random.default_rng([entropy, idx])
    s = int(traffic["image_size"])
    img0 = texture(s, s, rng)
    ang = rng.uniform(-0.1, 0.1)
    sc = rng.uniform(0.9, 1.1)
    tx, ty = rng.uniform(-20, 20, 2)
    c, si = np.cos(ang) * sc, np.sin(ang) * sc
    T = np.array([[1, 0, s / 2], [0, 1, s / 2], [0, 0, 1]])
    R = np.array([[c, -si, tx], [si, c, ty], [0, 0, 1]])
    H = (T @ R @ np.linalg.inv(T)).astype("float32")
    img1 = warp_image(img0, np.linalg.inv(H))
    return {"image0": to_uint8(img0), "image1": to_uint8(img1), "H": H,
            "Hinv": np.linalg.inv(H).astype("float32")}
