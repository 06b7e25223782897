"""Sequence datasets: KITTI, TartanAir, EuRoC, UMA, Video, Images
(counterpart of keypoint_bench_tpu/datasets/sequences.py).

Batch contracts mirror the reference loaders (datasets/kitti.py,
tartanair.py, euroc.py, uma.py, video.py, images.py) with NHWC numpy
images; the per-frame GT fundamental matrices are precomputed and cached
as .npy beside the ground truth. Frames decode without OpenCV
(datasets/imageio.py: PNG and PNM); EuRoC's undistortion and the video
reader are cv2 calls, imported when a frame is read.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from keypoint_bench_tpu_torch.datasets.imageio import (read_image,
                                                       resize_linear)
from keypoint_bench_tpu_torch.geometry import se3


def _import_cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (OpenCV), which is not "
                          f"installed") from e
    return cv2


def _fundamentals_from_poses(Ts, fx, fy, cx, cy):
    """Per-frame F[i] with x_i^T F x_{i-1} = 0 from world-from-cam poses
    (reference datasets/kitti.py:10-22: dp = Inv(pose[i+1]) * pose[i]);
    F[0] is zero."""
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Fs = [np.zeros((3, 3))]
    for i in range(len(Ts) - 1):
        dp = se3.inv_T(Ts[i + 1]) @ Ts[i]
        Fs.append(se3.pose_to_fundamental(dp, K, K))
    return np.stack(Fs).astype("float32")


def _cached_fundamentals(cache_path, Ts, fx, fy, cx, cy):
    if os.path.exists(cache_path):
        return np.load(cache_path)
    Fs = _fundamentals_from_poses(Ts, fx, fy, cx, cy)
    try:
        np.save(cache_path, Fs)
    except OSError:
        pass
    return Fs


def _read_kitti_poses(path):
    Ts = []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) < 12:
                continue
            T = np.eye(4)
            T[:3] = np.array(v[:12]).reshape(3, 4)
            Ts.append(T)
    return Ts


def _read_tum_poses(path, qw_first=False):
    """x y z qx qy qz qw lines (TartanAir mono gt format)."""
    Ts = []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) < 7:
                continue
            t = np.array(v[0:3])
            q = np.array([v[4], v[5], v[6], v[3]]) if qw_first else \
                np.array(v[3:7])
            Ts.append(se3.make_T(se3.quat_to_rotmat(q), t))
    return Ts


class KittiDataset:
    """KITTI odometry (reference datasets/kitti.py): stereo pair crop
    352x1216, GT SE3 + cached F matrices. `sequence_path` ends in '/':
    paths are joined by concatenation, as in the JAX package."""

    fx = 718.856
    fy = 718.856
    cx = 607.1928
    cy = 185.2157
    baseline = 0.54

    def __init__(self, sequence_path: str, gt_path: str, gray: bool = False):
        self.gray = gray
        self.image_0_list = sorted(glob.glob(sequence_path + "image_0/*"))
        self.image_1_list = sorted(glob.glob(sequence_path + "image_1/*"))
        self.poses = _read_kitti_poses(gt_path)
        self.Fs = _cached_fundamentals(
            gt_path.replace(".txt", "_fundamental.npy"), self.poses,
            self.fx, self.fy, self.cx, self.cy)

    def __len__(self):
        return len(self.image_0_list)

    def __getitem__(self, i):
        img0 = read_image(self.image_0_list[i], self.gray)[0:352, 0:1216]
        img1 = img0
        if self.image_1_list:
            img1 = read_image(self.image_1_list[i], self.gray)[0:352, 0:1216]
        last = max(0, i - 1)
        return {
            "image0": img0, "image1": img1,
            "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy,
            "bf": self.baseline * self.fx,
            "ground_truth": self.poses[i].astype("float32"),
            "last_ground_truth": self.poses[last].astype("float32"),
            "fundamental": self.Fs[i],
            "dataset": "Kitti",
        }


class TartanAirDataset:
    """TartanAir mono (reference datasets/tartanair.py): NED x y z qx qy qz qw
    GT, fx=fy=320, cx=320, cy=240."""

    fx = 320.0
    fy = 320.0
    cx = 320.0
    cy = 240.0

    def __init__(self, sequence_path: str, gt_path: str, gray: bool = False):
        self.gray = gray
        self.image_list = sorted(glob.glob(sequence_path + "*.png"))
        self.poses = _read_tum_poses(gt_path)
        self.Fs = _cached_fundamentals(
            gt_path.replace(".txt", "_fundamental.npy"), self.poses,
            self.fx, self.fy, self.cx, self.cy)

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, i):
        img0 = read_image(self.image_list[i], self.gray)
        last = max(0, i - 1)
        return {
            "image0": img0,
            "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy,
            "ground_truth": self.poses[i].astype("float32"),
            "last_ground_truth": self.poses[last].astype("float32"),
            "fundamental": self.Fs[i],
            "dataset": "TartanAir",
        }


def _read_cam(path):
    ts, imgs = [], []
    with open(path) as f:
        next(f)
        for line in f:
            parts = line.strip().split(",")
            ts.append(float(parts[0]))
            imgs.append(parts[1])
    return ts, imgs


class EurocDataset:
    """EuRoC MAV (reference datasets/euroc.py): cam0/cam1 CSV lists,
    undistortion (cv2.undistort, imported when a frame is read),
    body->cam0 extrinsic, nearest-timestamp GT alignment, width crop 736;
    the IMU CSV preintegrated between frames (`imu_between`)."""

    fx = 435.2046959714599
    fy = 435.2046959714599
    cx = 367.4517211914062
    cy = 252.2008514404297
    dist = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    baseline = 0.2090607502
    body2cam0 = np.array([
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0, 0, 0, 1.0]])

    def __init__(self, root: str, gray: bool = False):
        self.root = root
        self.gray = gray
        self.cam0_ts, self.cam0_imgs = _read_cam(root + "cam0/data.csv")
        self.cam1_ts, self.cam1_imgs = _read_cam(root + "cam1/data.csv")
        gt_ts, gt_Ts = self._read_gt(
            root + "state_groundtruth_estimate0/data.csv")
        gt_ts = np.asarray(gt_ts)
        self.poses = [gt_Ts[int(np.argmin(np.abs(gt_ts - t)))]
                      for t in self.cam0_ts]
        self.Fs = _cached_fundamentals(
            root + "state_groundtruth_estimate0/f.npy", self.poses,
            self.fx, self.fy, self.cx, self.cy)
        # IMU samples (the reference only stubs integration,
        # datasets/euroc.py:46-56; tasks/imu.py preintegrates them)
        self.imu_ts = np.zeros(0)
        self.imu_gyro = np.zeros((0, 3), np.float32)
        self.imu_accel = np.zeros((0, 3), np.float32)
        imu_csv = root + "imu0/data.csv"
        if os.path.exists(imu_csv):
            ts, gy, ac = [], [], []
            with open(imu_csv) as f:
                next(f)
                for line in f:
                    v = line.strip().split(",")
                    ts.append(float(v[0]))
                    gy.append([float(v[1]), float(v[2]), float(v[3])])
                    ac.append([float(v[4]), float(v[5]), float(v[6])])
            self.imu_ts = np.asarray(ts)
            self.imu_gyro = np.asarray(gy, np.float32)
            self.imu_accel = np.asarray(ac, np.float32)

    def imu_between(self, i: int):
        """Preintegrated IMU deltas over [frame i-1, frame i] (see
        tasks/imu.preintegrate), float32 CPU tensors. Returns None if no
        IMU data was found."""
        if len(self.imu_ts) == 0 or i == 0:
            return None
        import torch

        from keypoint_bench_tpu_torch.tasks.imu import preintegrate
        t0, t1 = self.cam0_ts[i - 1], self.cam0_ts[i]
        sel = (self.imu_ts >= t0) & (self.imu_ts < t1)
        dts = np.diff(self.imu_ts, append=self.imu_ts[-1]) / 1e9  # ns -> s
        return preintegrate(torch.from_numpy(self.imu_gyro),
                            torch.from_numpy(self.imu_accel),
                            torch.from_numpy(dts.astype(np.float32)),
                            torch.from_numpy(sel))

    def _read_gt(self, path):
        ts, Ts = [], []
        with open(path) as f:
            next(f)
            for line in f:
                v = line.strip().split(",")
                t = np.array([float(v[1]), float(v[2]), float(v[3])])
                # qw qx qy qz in file -> (x, y, z, w)
                q = np.array([float(v[5]), float(v[6]), float(v[7]),
                              float(v[4])])
                T = se3.make_T(se3.quat_to_rotmat(q), t) @ self.body2cam0
                ts.append(float(v[0]))
                Ts.append(T)
        return ts, Ts

    def __len__(self):
        return len(self.cam0_imgs)

    def __getitem__(self, i):
        cv2 = _import_cv2("EurocDataset's undistortion")
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                      [0, 0, 1.0]])

        def load(cam, name):
            img = cv2.imread(self.root + f"{cam}/data/" + name,
                             cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f"can not load {name}")
            img = cv2.undistort(img, K, self.dist)
            if self.gray:
                g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                return (g.astype("float32") / 255.0)[..., None][:, 0:736]
            rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            return (rgb.astype("float32") / 255.0)[:, 0:736]

        last = max(0, i - 1)
        return {
            "image0": load("cam0", self.cam0_imgs[i]),
            "image1": load("cam1", self.cam1_imgs[i]),
            "timestamp": self.cam0_ts[i],
            "ground_truth": self.poses[i].astype("float32"),
            "last_ground_truth": self.poses[last].astype("float32"),
            "fundamental": self.Fs[i],
            "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy,
            "bf": self.baseline * self.fx,
            "dataset": "Euroc",
        }


class UMADataset:
    """UMA-VI stereo (reference datasets/uma.py): images + timestamps only."""

    def __init__(self, root: str, gray: bool = False):
        self.root = root
        self.gray = gray
        self.ts, self.cam0 = _read_cam(root + "cam0/data.csv")
        _, self.cam1 = _read_cam(root + "cam1/data.csv")

    def __len__(self):
        return len(self.cam0)

    def __getitem__(self, i):
        return {
            "image0": read_image(self.root + "cam0/data/" + self.cam0[i],
                                 self.gray),
            "image1": read_image(self.root + "cam1/data/" + self.cam1[i],
                                 self.gray),
            "timestamp": self.ts[i],
        }


def _resized(img, resize):
    """img, or resize_linear to (w, h) = resize (a channel axis of 1
    kept, as the JAX loaders put back the one cv2.resize drops)."""
    return img if resize is None else resize_linear(img, resize)


class VideoDataset:
    """Sequential video frames (reference datasets/video.py), read with
    cv2.VideoCapture."""

    def __init__(self, root: str, gray: bool = False, resize=None):
        cv2 = _import_cv2("VideoDataset")
        self.gray = gray
        self.resize = resize
        self.video = cv2.VideoCapture(root)
        self.n = int(self.video.get(cv2.CAP_PROP_FRAME_COUNT))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        cv2 = _import_cv2("VideoDataset")
        ok, img = self.video.read()
        if not ok or img is None:
            raise IOError(f"video frame {i} could not be read")
        if self.gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            img = (img.astype("float32") / 255.0)[..., None]
        else:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype("float32") / 255.
        return {"image0": _resized(img, self.resize)}


class ImagesDataset:
    """Directory of demo images (reference datasets/images.py)."""

    def __init__(self, root: str, gray: bool = False, resize=None):
        self.gray = gray
        self.resize = resize
        self.items = sorted(glob.glob(root + "/*"))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return {"image0": _resized(read_image(self.items[i], self.gray),
                                   self.resize)}
