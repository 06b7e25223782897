"""Visualization + result writers (counterpart of
keypoint_bench_tpu/utils/visualization.py; reference utils/visualization.py:
plot_kps_error 7-57, plot_epipolar_lines 60-126, plot_matches 129-192,
write_txt 195-206). Host-side numpy; cv2 and matplotlib are imported inside
the functions, which run only behind the runner's save_images flag and
save_metric_plot, never in the metric hot path. Images and points are
numpy arrays (the runner moves tensors to the host first).
"""
from __future__ import annotations

import numpy as np


def _to_u8_image(img) -> np.ndarray:
    """img: [H,W,C] (or [1,H,W,C]) float [0,1] numpy -> BGR uint8."""
    import cv2
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if u8.shape[-1] == 1:
        u8 = np.repeat(u8, 3, axis=-1)
    return cv2.cvtColor(u8, cv2.COLOR_RGB2BGR)


def plot_kps_error(img, kpts, valid=None, errors=None, max_error=3.0,
                   radius=2, color=(255, 0, 0)):
    """Draw keypoints colored by error (blue->red ramp like the reference)."""
    import cv2
    show = _to_u8_image(img)
    h, w = show.shape[:2]
    kpts = np.asarray(kpts)
    valid = np.ones(len(kpts), bool) if valid is None else np.asarray(valid)
    errors = None if errors is None else np.asarray(errors)
    for i, kp in enumerate(kpts):
        if not valid[i]:
            continue
        x = int(kp[0] * (w - 1))
        y = int(kp[1] * (h - 1))
        if errors is not None and np.isfinite(errors[i]):
            r = min(float(errors[i]) / max_error, 1.0)
            c = (int(255 * (1 - r)), 0, int(255 * r))
        else:
            c = tuple(int(v) for v in color)
        cv2.circle(show, (x, y), radius, c, -1)
    return show


def plot_matches(img0, img1, pts0_px, pts1_px, color=(0, 255, 0)):
    """Side-by-side pair with match lines (pixel coords)."""
    import cv2
    a = _to_u8_image(img0)
    b = _to_u8_image(img1)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    for p, q in zip(np.asarray(pts0_px), np.asarray(pts1_px)):
        cv2.line(canvas, (int(p[0]), int(p[1])),
                 (int(q[0]) + off, int(q[1])), color, 1)
    return canvas


def plot_epipolar_lines(img, pts0_px, pts1_px, F, n: int = 30):
    """Draw epipolar lines l1 = F x0 over the image with the matched points."""
    import cv2
    show = _to_u8_image(img)
    h, w = show.shape[:2]
    pts0 = np.asarray(pts0_px)[:n]
    pts1 = np.asarray(pts1_px)[:n]
    F = np.asarray(F)
    for p0, p1 in zip(pts0, pts1):
        l = F @ np.array([p0[0], p0[1], 1.0])
        if abs(l[1]) < 1e-9:
            continue
        y0 = int(-l[2] / l[1])
        y1 = int(-(l[2] + l[0] * (w - 1)) / l[1])
        cv2.line(show, (0, y0), (w - 1, y1), (0, 255, 0), 1)
        cv2.circle(show, (int(p1[0]), int(p1[1])), 3, (0, 0, 255), -1)
    return show


def plot_series(values, save_path):
    """Per-pair metric curve PNG + txt dump (reference plot_repeatability /
    plot_fundamental_matrix / plot_tracking_error shape)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.plot(np.asarray(values))
    plt.savefig(save_path)
    plt.close()
    write_txt(str(save_path).replace(".png", ".txt"), values)


def plot_trajectory_3d(t_est, save_path):
    """3D trajectory plot (reference plot_visual_odometry)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    t = np.asarray(t_est).reshape(-1, 3)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.plot3D(t[:, 0], t[:, 1], t[:, 2])
    fig.savefig(save_path)
    plt.close(fig)


def write_txt(path, values):
    with open(path, "w") as f:
        for v in np.asarray(values).reshape(-1):
            f.write(f"{float(v)}\n")
