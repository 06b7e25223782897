"""Synthetic homography pairs for data-free runs: the port's own copy of
keypoint_bench_tpu/datasets/synthetic.py (_texture, _warp_image,
SyntheticHomographyDataset), numpy only, same draws from the same seed.
"""
from __future__ import annotations

import numpy as np


def _texture(h, w, rng, blocks=8):
    base = rng.random((h // blocks, w // blocks))
    img = np.kron(base, np.ones((blocks, blocks)))
    # light smoothing for gradient structure
    k = np.ones((3, 3)) / 9.0
    from scipy.signal import convolve2d
    img = convolve2d(img, k, mode="same", boundary="symm")
    rgb = np.stack([img, np.roll(img, 3, 0), np.roll(img, 3, 1)], axis=-1)
    return rgb.astype("float32")


def _warp_image(img, H_inv):
    """Inverse-warp with bilinear sampling (numpy)."""
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


class SyntheticHomographyDataset:
    """HPatches-contract pairs under random homographies."""

    def __init__(self, num_pairs: int = 8, image_size: int = 512,
                 seed: int = 0):
        self.n = num_pairs
        self.s = image_size
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        s = self.s
        img0 = _texture(s, s, rng)
        # mild random perspective warp around the center
        ang = rng.uniform(-0.1, 0.1)
        sc = rng.uniform(0.9, 1.1)
        tx, ty = rng.uniform(-20, 20, 2)
        c, si = np.cos(ang) * sc, np.sin(ang) * sc
        T = np.array([[1, 0, s / 2], [0, 1, s / 2], [0, 0, 1]])
        R = np.array([[c, -si, tx], [si, c, ty], [0, 0, 1]])
        H = (T @ R @ np.linalg.inv(T)).astype("float32")
        img1 = _warp_image(img0, np.linalg.inv(H))
        return {
            "image0": img0, "image1": img1,
            "warp01_params": {"mode": "homo", "width": s, "height": s,
                              "homography_matrix": H, "resize": s},
            "warp10_params": {"mode": "homo", "width": s, "height": s,
                              "homography_matrix":
                                  np.linalg.inv(H).astype("float32"),
                              "resize": s},
            "dataset": "HPatches",
        }
