"""Image-pair datasets: HPatches, MegaDepth, ImagePairs (counterpart of
keypoint_bench_tpu/datasets/pairs.py).

Batch contracts mirror the reference loaders (datasets/hpatches.py:74-83,
datasets/megadepth.py:329-354, datasets/image_pairs.py:19-57) with NHWC
numpy images: the same keys, dtypes and shapes as the JAX package's
items. Images decode without OpenCV (datasets/imageio.py, and the native
PNM loader for HPatches in colour); MegaDepth reads its depths and
calibrations without h5py (datasets/h5.py) and its JPEGs with PIL,
imported when a pair is read.
"""
from __future__ import annotations

import glob
import json
from pathlib import Path

import numpy as np

from keypoint_bench_tpu_torch.datasets import h5
from keypoint_bench_tpu_torch.datasets.imageio import (_pnm_tokens,
                                                       read_image,
                                                       resize_linear)


def _pnm_size(path):
    """(width, height) from a P5/P6 header without decoding pixels; a
    comment line may hold spaces (the JAX package's copy reads its words
    as tokens)."""
    with open(path, "rb") as f:
        (magic, w, h), _ = _pnm_tokens(f.read(4096), 3)
    if magic not in (b"P5", b"P6"):
        raise IOError(f"{path} is not a binary P5/P6 PNM")
    return int(w), int(h)


class HPatchesDataset:
    """HPatches sequences: pairs (1, k) k=2..6 with GT homographies, images
    resized to image_size^2 (reference datasets/hpatches.py). In colour the
    native loader decodes and resizes (runtime/loader.cpp, bit-equal to the
    JAX package's); it raises if the loader does not build. `gray` and
    `use_native=False` take imageio + resize_linear."""

    def __init__(self, root: str, alteration: str = "all",
                 image_size: int = 512, gray: bool = False,
                 use_native: bool = True):
        if not Path(root).exists():
            raise FileNotFoundError(f"dataset root {root} does not exist")
        self.image_size = image_size
        self.gray = gray
        self.use_native = use_native and not gray
        self.items = []
        for folder in sorted(p for p in Path(root).iterdir() if p.is_dir()):
            if alteration in ("i", "v") and folder.stem[0] != alteration:
                continue
            n = len(glob.glob(str(folder / "*.ppm")))
            for i in range(2, 1 + n):
                self.items.append((folder / "1.ppm", folder / f"{i}.ppm",
                                   folder / f"H_1_{i}"))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        p0, p1, hp = self.items[idx]
        s = self.image_size
        if self.use_native:
            from keypoint_bench_tpu_torch.runtime import load_pnm_resized
            # original sizes from the PNM header (cheap text read)
            w0, h0 = _pnm_size(p0)
            w1, h1 = _pnm_size(p1)
            img0 = load_pnm_resized(str(p0), s, s)
            img1 = load_pnm_resized(str(p1), s, s)
        else:
            img0 = read_image(p0, self.gray)
            img1 = read_image(p1, self.gray)
            h0, w0 = img0.shape[:2]
            h1, w1 = img1.shape[:2]
            img0 = resize_linear(img0, (s, s))
            img1 = resize_linear(img1, (s, s))
        H = np.loadtxt(hp).astype("float32")
        return {
            "image0": img0, "image1": img1,
            "warp01_params": {"mode": "homo", "width": w1, "height": h1,
                              "homography_matrix": H, "resize": s},
            "warp10_params": {"mode": "homo", "width": w0, "height": h0,
                              "homography_matrix": np.linalg.inv(H),
                              "resize": s},
            "dataset": "HPatches",
        }


def _scale_intrinsics(K, sx, sy):
    """reference utils/projection.py:7-9: K' = diag(1/sx, 1/sy, 1) @ K."""
    S = np.diag([1.0 / sx, 1.0 / sy, 1.0]).astype("float32")
    return S @ K


def _central_match(depth0, K0, depth1, K1, pose01, rng, downsample=10):
    """Pick a covisible pixel of view0 and its projection in view1 via a
    z-buffered depth warp (reference megadepth.py:176-210 central_match)."""
    d0 = resize_linear(depth0, (depth0.shape[1] // downsample,
                                depth0.shape[0] // downsample))
    K0s = _scale_intrinsics(K0, downsample, downsample)
    K1s = _scale_intrinsics(K1, downsample, downsample)
    h, w = d0.shape
    ys, xs = np.mgrid[0:h, 0:w]
    valid = d0 > 0
    if not valid.any():
        return (np.array([depth0.shape[0] / 2, depth0.shape[1] / 2]),
                np.array([depth1.shape[0] / 2, depth1.shape[1] / 2]))
    idx = rng.integers(0, int(valid.sum()))
    y0 = ys[valid].ravel()[idx]
    x0 = xs[valid].ravel()[idx]
    z = d0[y0, x0]
    X = np.linalg.inv(K0s) @ np.array([x0 * z, y0 * z, z])
    X1 = pose01[:3, :3] @ X + pose01[:3, 3]
    uv1 = K1s @ X1
    uv1 = uv1[:2] / max(uv1[2], 1e-9)
    return (np.array([y0, x0]) * downsample, uv1[::-1] * downsample)


def _import_pil_image():
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("MegaDepthDataset reads its JPEGs with PIL; "
                          "missing: PIL (Pillow)") from None
    return Image


class MegaDepthDataset:
    """MegaDepth pairs with depth/pose/intrinsics SE3 warp params
    (reference datasets/megadepth.py). Test path: no crop (bbox = 0), the
    images at their own size. Train path supports the reference's
    crop_or_scale modes:
      'scale'      resize both views to image_size^2, rescale intrinsics
      'crop'       pad + crop image_size^2 windows around a covisible
                   central match (bbox offsets flow into the SE3 warp)
      'crop_scale' crop a max square around the match, then resize
    """

    def __init__(self, root: str, image_size: int = 512, gray: bool = False,
                 train: bool = False, crop_or_scale: str = "scale",
                 seed: int = 0):
        self.root = Path(root)
        self.image_size = image_size
        self.gray = gray
        self.train = train
        self.crop_or_scale = crop_or_scale
        self._rng = np.random.default_rng(seed)
        with open(self.root / "dataset.json") as f:
            scenes = json.load(f)
        self.pairs = []
        for scene_name, sd in scenes.items():
            image_path = Path(sd["image_path"])
            depth_path = Path(sd["depth_path"])
            calib_path = Path(sd["calib_path"])
            for indices in sd["tuples"]:
                i, j = indices[0], indices[1]
                self.pairs.append(tuple(
                    self._paths(sd["images"][k], image_path, depth_path,
                                calib_path) for k in (i, j)))

    def _paths(self, name, image_path, depth_path, calib_path):
        base = name.split(".")[0] if name.endswith("jpg") else name
        img_name = name if name.endswith("jpg") else base + ".jpg"
        return (image_path / img_name, depth_path / (base + ".h5"),
                self.root / calib_path / f"calibration_{base}.h5")

    def __len__(self):
        return len(self.pairs)

    def _read_one(self, paths):
        Image = _import_pil_image()
        ipath, dpath, cpath = paths
        depth = h5.read(self.root / dpath, "/depth").astype("float32")
        with Image.open(self.root / ipath) as img:
            if img.mode != "RGB":
                img = img.convert("RGB")
            img = np.array(img).astype("float32") / 255.0
        pose = np.eye(4, dtype="float32")
        with h5.File(cpath) as f:
            K = f["K"].astype("float32")
            pose[:3, :3] = f["R"]
            pose[:3, 3] = f["T"]
        return img, depth, K, pose

    @staticmethod
    def _pad_min(img, depth, size):
        h, w = img.shape[:2]
        ph, pw = max(size - h, 0), max(size - w, 0)
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            depth = np.pad(depth, ((0, ph), (0, pw)))
        return img, depth

    @staticmethod
    def _crop_at(img, depth, center_rc, size):
        h, w = img.shape[:2]
        r = int(np.clip(center_rc[0] - size // 2, 0, max(h - size, 0)))
        c = int(np.clip(center_rc[1] - size // 2, 0, max(w - size, 0)))
        return (img[r:r + size, c:c + size], depth[r:r + size, c:c + size],
                np.array([r, c], "float32"))

    def _train_transform(self, img1, depth1, K1, img2, depth2, K2, pose12):
        s = self.image_size
        if self.crop_or_scale == "scale":
            h1, w1 = img1.shape[:2]
            h2, w2 = img2.shape[:2]
            img1 = resize_linear(img1, (s, s))
            depth1 = resize_linear(depth1, (s, s))
            K1 = _scale_intrinsics(K1, w1 / s, h1 / s)
            img2 = resize_linear(img2, (s, s))
            depth2 = resize_linear(depth2, (s, s))
            K2 = _scale_intrinsics(K2, w2 / s, h2 / s)
            z2 = np.zeros(2, "float32")
            return img1, depth1, K1, z2, img2, depth2, K2, z2
        c1, c2 = _central_match(depth1, K1, depth2, K2, pose12, self._rng)
        if self.crop_or_scale == "crop":
            img1, depth1 = self._pad_min(img1, depth1, s)
            img2, depth2 = self._pad_min(img2, depth2, s)
            img1, depth1, b1 = self._crop_at(img1, depth1, c1, s)
            img2, depth2, b2 = self._crop_at(img2, depth2, c2, s)
            return img1, depth1, K1, b1, img2, depth2, K2, b2
        if self.crop_or_scale == "crop_scale":
            def one(img, depth, K, c):
                sq = min(img.shape[:2])
                img, depth, b = self._crop_at(img, depth, c, sq)
                K = K.copy()
                K[0, 2] -= b[1]
                K[1, 2] -= b[0]
                img = resize_linear(img, (s, s))
                depth = resize_linear(depth, (s, s))
                K = _scale_intrinsics(K, sq / s, sq / s)
                return img, depth, K
            img1, depth1, K1 = one(img1, depth1, K1, c1)
            img2, depth2, K2 = one(img2, depth2, K2, c2)
            z2 = np.zeros(2, "float32")
            return img1, depth1, K1, z2, img2, depth2, K2, z2
        raise ValueError(f"unknown crop_or_scale {self.crop_or_scale!r}")

    @staticmethod
    def _warp(img_a, img_b, pose, b_a, b_b, depth_a, depth_b, K_a, K_b):
        return {"mode": "se3", "width": img_a.shape[1],
                "height": img_a.shape[0], "pose01": pose, "bbox0": b_a,
                "bbox1": b_b, "depth0": depth_a, "depth1": depth_b,
                "intrinsics0": K_a, "intrinsics1": K_b}

    def __getitem__(self, idx):
        img1, depth1, K1, pose1 = self._read_one(self.pairs[idx][0])
        img2, depth2, K2, pose2 = self._read_one(self.pairs[idx][1])
        pose12 = (pose2 @ np.linalg.inv(pose1)).astype("float32")
        pose21 = np.linalg.inv(pose12).astype("float32")
        b1 = b2 = np.zeros(2, "float32")
        if self.train:
            (img1, depth1, K1, b1, img2, depth2, K2, b2) = \
                self._train_transform(img1, depth1, K1, img2, depth2, K2,
                                      pose12)
        return {
            "image0": img1, "image1": img2,
            "warp01_params": self._warp(img1, img2, pose12, b1, b2, depth1,
                                        depth2, K1, K2),
            "warp10_params": self._warp(img2, img1, pose21, b2, b1, depth2,
                                        depth1, K2, K1),
            "dataset": "megaDepth",
        }


class ImagePairsDataset:
    """txt-listed image pairs (reference datasets/image_pairs.py)."""

    def __init__(self, path_file: str, gray: bool = False, resize=None):
        self.gray = gray
        self.resize = resize
        with open(path_file) as f:
            self.items = [line.strip().split()[:2]
                          for line in f if line.strip()]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        a, b = self.items[idx]
        img0 = read_image(a, self.gray)
        img1 = read_image(b, self.gray)
        if self.resize is not None:
            img0 = resize_linear(img0, self.resize)
            img1 = resize_linear(img1, self.resize)
        return {"image0": img0, "image1": img1, "dataset": "image_pair"}
