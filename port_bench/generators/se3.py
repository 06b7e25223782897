"""Relative-pose pairs: a copy of the port's
`datasets/synthetic.SyntheticSE3Dataset` and the splat renderer it uses,
numpy only.

Random 3D blobs (depths 4-20) are z-buffer splatted over two textured
fronto-parallel planes (depths 30 and 14) and seen from two cameras with a
small random rotation and a 0.3-0.7 baseline, so the pair has true
parallax; the intrinsics are f = 0.9 S, centre S / 2. Pair `idx` of a
pool draws from its own generator seeded with (pool entropy, idx).
"""
from __future__ import annotations

import numpy as np

from port_bench.generators.homography import texture, to_uint8, warp_image

_BG_DEPTHS = (30.0, 14.0)


def rodrigues(aa) -> np.ndarray:
    """Axis-angle 3-vector -> rotation matrix (cv2.Rodrigues' closed form)."""
    aa = np.asarray(aa, np.float64).reshape(3)
    theta = float(np.linalg.norm(aa))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    r = aa * (1.0 / theta)
    r_x = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                    [-r[1], r[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * r_x


class SplatScene:
    """The renderer: square frames of side `size` through K."""

    def __init__(self, size: int):
        self.h = self.w = size
        f = size * 0.9
        self.K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]],
                          np.float32)

    def _plane(self, tex, R, t, d):
        """One textured plane at depth d (camera 0's frame) seen from
        camera (R, t): (image, depth, camera-0 visibility of its left
        half)."""
        h, w = self.h, self.w
        n = np.array([0.0, 0.0, 1.0])
        H = self.K @ (R + np.outer(t, n) / d) @ np.linalg.inv(self.K)
        img = warp_image(tex, np.linalg.inv(H))
        ys, xs = np.mgrid[0:h, 0:w]
        p1 = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], axis=1)
        p0 = p1 @ np.linalg.inv(H).T
        p0 = p0 / p0[:, 2:]
        inb = ((p0[:, 0] >= 0) & (p0[:, 0] <= w - 1)
               & (p0[:, 1] >= 0) & (p0[:, 1] <= h - 1)).reshape(h, w)
        ray0 = p0 @ np.linalg.inv(self.K).T
        X0 = ray0 * (d / ray0[:, 2:])
        X1 = X0 @ R.T + t
        depth = X1[:, 2].reshape(h, w).astype(np.float32)
        return img, depth, inb & (p0[:, 0].reshape(h, w) < w / 2)

    def _background(self, tex, R, t):
        d_far, d_near = _BG_DEPTHS
        img, depth, _ = self._plane(tex, R, t, d_far)
        # the nearer plane takes the left half of camera 0's view, with
        # another crop of the texture
        tex2 = np.roll(tex, (self.h // 3, self.w // 3), axis=(0, 1))
        img2, depth2, mask2 = self._plane(tex2, R, t, d_near)
        img = np.where(mask2[..., None], img2, img)
        depth = np.where(mask2, depth2, depth)
        return img, depth

    def render(self, X, colors, R, t, tex) -> np.ndarray:
        """Splat points X [N,3] far to near over the planes -> image."""
        h, w = self.h, self.w
        img, depth = self._background(tex, R, t)
        zbuf = depth.copy()
        Xc = X @ R.T + t
        z = Xc[:, 2]
        front = z > 0.5
        uv = (Xc / np.maximum(z[:, None], 1e-6)) @ self.K.T
        rad = 4
        for i in np.argsort(-z):
            if not front[i]:
                continue
            u, v = uv[i, 0], uv[i, 1]
            if not (rad <= u < w - rad and rad <= v < h - rad):
                continue
            ui, vi = int(u), int(v)
            ys, xs = np.mgrid[vi - rad: vi + rad + 1, ui - rad: ui + rad + 1]
            g = np.exp(-((ys - v) ** 2 + (xs - u) ** 2) / (2 * 1.8 ** 2))
            img[ys, xs] = (1 - g[..., None]) * img[ys, xs] \
                + g[..., None] * colors[i]
            sel = (g > 0.1) & (z[i] < zbuf[ys, xs])
            zbuf[ys, xs] = np.where(sel, z[i], zbuf[ys, xs])
        return img


def make_pair(entropy: int, idx: int, traffic: dict) -> dict:
    """Pair `idx`: uint8 images [S,S,3], intrinsics K0 = K1 [3,3] and the
    ground-truth pose01 [4,4] (camera 0 at the origin)."""
    rng = np.random.default_rng([entropy, idx])
    s = int(traffic["image_size"])
    n_blobs = int(traffic["blobs"])
    scene = SplatScene(s)
    # a wide depth range keeps the scene far from planar
    X = np.concatenate([rng.uniform(-4, 4, (n_blobs, 2)),
                        rng.uniform(4, 20, (n_blobs, 1))], axis=1)
    colors = rng.uniform(0.3, 1.0, (n_blobs, 3)).astype(np.float32)
    R1 = rodrigues(rng.normal(0, 0.03, 3))
    t1 = np.array([rng.uniform(0.3, 0.7), rng.uniform(-0.2, 0.2),
                   rng.uniform(-0.1, 0.1)])
    # dim, low-contrast background: detections gather on the blobs
    tex = texture(s, s, rng) * 0.15
    img0 = scene.render(X, colors, np.eye(3), np.zeros(3), tex)
    img1 = scene.render(X, colors, R1, t1, tex)
    pose01 = np.eye(4)
    pose01[:3, :3], pose01[:3, 3] = R1, t1
    return {"image0": to_uint8(img0), "image1": to_uint8(img1),
            "K0": scene.K, "K1": scene.K.copy(),
            "pose01": pose01.astype(np.float32)}
