"""Synthetic datasets for data-free runs: the port's own copy of
keypoint_bench_tpu/datasets/synthetic.py (_texture, _warp_image,
SyntheticHomographyDataset, SyntheticSE3Dataset, SyntheticSequenceDataset,
SyntheticSplatSequenceDataset with the splat renderer they share), numpy
and scipy only, same draws from the same seed.
"""
from __future__ import annotations

import numpy as np

from keypoint_bench_tpu_torch.datasets.sequences import \
    _fundamentals_from_poses


def rodrigues(aa) -> np.ndarray:
    """Axis-angle 3-vector -> 3x3 rotation matrix, float64: the closed form
    c I + (1 - c) r r^T + s [r]_x of cv2.Rodrigues, with its small-angle
    case (the identity below machine epsilon)."""
    aa = np.asarray(aa, np.float64).reshape(3)
    theta = float(np.linalg.norm(aa))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    r = aa * (1.0 / theta)
    r_x = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                    [-r[1], r[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * r_x


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


class _SplatScene:
    """The 3D gaussian-splat renderer of SyntheticSE3Dataset (its
    intrinsics, `_plane`, `_background` and `_render`): random blobs
    z-buffer-splatted over two textured planes at different depths, which
    break the single-plane degeneracy. Square at image_size with its own
    intrinsics by default; `width` and `K` render a height x width frame
    through other intrinsics (the file-backed datasets' cameras)."""

    _BG_DEPTHS = (30.0, 14.0)

    def __init__(self, image_size: int, width: int | None = None,
                 K: np.ndarray | None = None):
        self.h = image_size
        self.w = image_size if width is None else width
        f = image_size * 0.9
        self.K = np.array([[f, 0, image_size / 2],
                           [0, f, image_size / 2], [0, 0, 1]], np.float32) \
            if K is None else np.asarray(K, np.float32)

    def _plane(self, tex, R, t, d):
        """One textured fronto-parallel plane at depth d (cam0 frame)
        rendered into camera (R, t): (image, exact depth, cam0-visibility
        mask)."""
        h, w = self.h, self.w
        n = np.array([0.0, 0.0, 1.0])
        H = self.K @ (R + np.outer(t, n) / d) @ np.linalg.inv(self.K)
        img = _warp_image(tex, np.linalg.inv(H))
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
        d_far, d_near = self._BG_DEPTHS
        img, depth, _ = self._plane(tex, R, t, d_far)
        # the nearer plane takes the left half of the cam0 view, with
        # another crop of the texture
        tex2 = np.roll(tex, (self.h // 3, self.w // 3), axis=(0, 1))
        img2, depth2, mask2 = self._plane(tex2, R, t, d_near)
        m = mask2[..., None]
        img = np.where(m, img2, img)
        depth = np.where(mask2, depth2, depth)
        return img, depth

    def _render(self, X, colors, R, t, tex):
        """Splat 3D points X [N,3] over the textured planes with a
        z-buffer. Returns (image [H,W,3], depth [H,W]); `tex` is [H,W,3]."""
        h, w = self.h, self.w
        img, depth = self._background(tex, R, t)
        zbuf = depth.copy()
        Xc = X @ R.T + t
        z = Xc[:, 2]
        front = z > 0.5
        uv = (Xc / np.maximum(z[:, None], 1e-6)) @ self.K.T
        order = np.argsort(-z)  # far to near; near overwrites
        rad = 4
        for i in order:
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
            closer = z[i] < zbuf[ys, xs]
            sel = (g > 0.1) & closer
            depth[ys, xs] = np.where(sel, z[i], depth[ys, xs])
            zbuf[ys, xs] = np.where(sel, z[i], zbuf[ys, xs])
        return img, depth


class SyntheticSE3Dataset:
    """MegaDepth-contract pairs rendered from the 3D gaussian-splat scene:
    random 3D blobs z-buffer-splatted into two cameras with a relative
    rotation and translation, with exact per-pixel depth maps. Genuine
    parallax, so the essential-matrix task (AUC) runs without MegaDepth."""

    def __init__(self, num_pairs: int = 4, image_size: int = 256,
                 seed: int = 0, n_blobs: int = 900):
        self.n = num_pairs
        self.s = image_size
        self.seed = seed
        self.n_blobs = n_blobs
        self.scene = _SplatScene(image_size)
        self.K = self.scene.K

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + 31 * idx)
        # a wide depth range keeps the scene far from planar
        X = np.concatenate([rng.uniform(-4, 4, (self.n_blobs, 2)),
                            rng.uniform(4, 20, (self.n_blobs, 1))], axis=1)
        colors = rng.uniform(0.3, 1.0, (self.n_blobs, 3)).astype(np.float32)
        R0, t0 = np.eye(3), np.zeros(3)
        R1 = rodrigues(rng.normal(0, 0.03, 3))
        t1 = np.array([rng.uniform(0.3, 0.7), rng.uniform(-0.2, 0.2),
                       rng.uniform(-0.1, 0.1)])
        # dim, low-contrast background: detections gather on the blobs
        tex = _texture(self.s, self.s, rng) * 0.15
        img0, depth0 = self.scene._render(X, colors, R0, t0, tex)
        img1, depth1 = self.scene._render(X, colors, R1, t1, tex)
        T0, T1 = np.eye(4), np.eye(4)
        T0[:3, :3], T0[:3, 3] = R0, t0
        T1[:3, :3], T1[:3, 3] = R1, t1
        pose01 = (T1 @ np.linalg.inv(T0)).astype(np.float32)
        pose10 = np.linalg.inv(pose01).astype(np.float32)
        z2 = np.zeros(2, np.float32)

        def params(pose, d0, d1):
            return {"mode": "se3", "width": self.s, "height": self.s,
                    "pose01": pose, "bbox0": z2, "bbox1": z2, "depth0": d0,
                    "depth1": d1, "intrinsics0": self.K,
                    "intrinsics1": self.K}

        return {"image0": img0, "image1": img1,
                "warp01_params": params(pose01, depth0, depth1),
                "warp10_params": params(pose10, depth1, depth0),
                "dataset": "megaDepth"}


class SyntheticSplatSequenceDataset:
    """KITTI-contract mono sequence rendered from the 3D gaussian-splat
    scene (true parallax, unlike SyntheticSequenceDataset's single plane)."""

    def __init__(self, num_frames: int = 6, image_size: int = 256,
                 seed: int = 0, n_blobs: int = 900):
        self.n = num_frames
        self.base = _SplatScene(image_size)
        rng = np.random.default_rng(seed)
        self.X = np.concatenate([rng.uniform(-4, 4, (n_blobs, 2)),
                                 rng.uniform(4, 20, (n_blobs, 1))], axis=1)
        self.colors = rng.uniform(0.3, 1.0, (n_blobs, 3)).astype(np.float32)
        self.tex = _texture(image_size, image_size, rng) * 0.15
        self.poses_cam = []   # cam-from-world per frame
        for i in range(num_frames):
            R = rodrigues([0.0, 0.002 * i, 0.0])
            t = np.array([0.35 * i, 0.05 * i, 0.0])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            self.poses_cam.append(T)
        # world-from-cam for the ground-truth contract
        self.poses = [np.linalg.inv(T) for T in self.poses_cam]
        K = self.base.K
        self.Fs = _fundamentals_from_poses(self.poses, K[0, 0], K[1, 1],
                                           K[0, 2], K[1, 2])

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        T = self.poses_cam[i]
        img, _ = self.base._render(self.X, self.colors, T[:3, :3], T[:3, 3],
                                   self.tex)
        last = max(0, i - 1)
        K = self.base.K
        return {
            "image0": img, "image1": img,
            "fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
            "ground_truth": self.poses[i].astype("float32"),
            "last_ground_truth": self.poses[last].astype("float32"),
            "fundamental": self.Fs[i],
            "dataset": "Kitti",
        }


class SyntheticSequenceDataset:
    """KITTI-contract mono sequence: a camera translating over a textured
    fronto-parallel plane at depth z0 (the image motion is the homography
    the plane induces), with ground-truth poses and fundamental matrices."""

    fx = 256.0
    fy = 256.0

    def __init__(self, num_frames: int = 10, image_size: int = 256,
                 seed: int = 0):
        self.n = num_frames
        self.s = image_size
        self.cx = image_size / 2.0
        self.cy = image_size / 2.0
        rng = np.random.default_rng(seed)
        self.base = _texture(image_size * 2, image_size * 2, rng)
        z0 = 8.0
        self.z0 = z0
        # the plane-induced pixel drift must stay inside the double-size
        # base texture's margin (off = image_size // 2)
        max_drift = max(self.fx * 0.08, self.fy * 0.02) * (num_frames - 1) \
            / z0
        if max_drift >= image_size // 2:
            raise ValueError(
                f"SyntheticSequenceDataset: {num_frames} frames drift "
                f"{max_drift:.0f} px past the base-texture margin "
                f"({image_size // 2} px): use fewer frames or a larger "
                f"image_size")
        self.poses = []
        for i in range(num_frames):
            T = np.eye(4)
            T[0, 3] = 0.08 * i           # x drift (world-from-cam)
            T[1, 3] = 0.02 * i
            self.poses.append(T)
        self.Fs = _fundamentals_from_poses(self.poses, self.fx, self.fy,
                                           self.cx, self.cy)

    def __len__(self):
        return self.n

    def _frame(self, i):
        # plane at depth z0: pixel shift = fx * t / z0; a window of the
        # double-size base texture
        dx = int(round(self.fx * self.poses[i][0, 3] / self.z0))
        dy = int(round(self.fy * self.poses[i][1, 3] / self.z0))
        s = self.s
        off = s // 2
        return self.base[off - dy:off - dy + s, off - dx:off - dx + s]

    def __getitem__(self, i):
        last = max(0, i - 1)
        return {
            "image0": self._frame(i),
            "image1": self._frame(i),
            "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy,
            "ground_truth": self.poses[i].astype("float32"),
            "last_ground_truth": self.poses[last].astype("float32"),
            "fundamental": self.Fs[i],
            "dataset": "Kitti",
        }
