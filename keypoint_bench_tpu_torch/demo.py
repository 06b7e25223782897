"""End-to-end demo on a synthetic pair, with no data to download: detect,
match by brute force, estimate the homography and render overlays (the
port's counterpart of examples/demo.py).

    python -m keypoint_bench_tpu_torch.demo [--model Alike] [--out DIR]
                                            [--size 512] [--device cuda]

The model's forward, then `detection` (kernel A on the card) and
`brute_force_match` (kernel D on the card), then RANSAC-H on the matches
with the draws of a `torch.Generator` seeded 0. Writes keypoints0.png,
keypoints1.png and, for a model with descriptors, matches.png into --out
(output/demo by default), and prints the keypoint and match counts and
the estimated homography beside the ground truth, both normalized. It
runs on the card unless `--device cpu` asks for the plain path.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from keypoint_bench_tpu_torch.device import resolve_device

DETECT = {"nms_dist": 6, "border_dist": 8, "top_k": 1000}
MAX_DISTANCE = 5.0


def load_model(name: str, device: torch.device):
    """The registered model `name` on `device`, with its weights (or, for
    a model configured by model_params, its defaults)."""
    from keypoint_bench_tpu_torch.models import PARAM_MODELS, get_model
    from keypoint_bench_tpu_torch.weights import load_params
    params = {} if name in PARAM_MODELS else load_params(name,
                                                         device=device)
    return get_model(name)(params).eval()


@torch.inference_mode()
def pipeline(model, img0: torch.Tensor, img1: torch.Tensor):
    """Both forwards, detection and brute-force matching of one pair of
    [H,W,3] images: (k0, v0, k1, v1, m0, m1, ok), the last three None for a
    detector without descriptors."""
    from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection
    from keypoint_bench_tpu_torch.ops.matching import brute_force_match
    dp = DetectParams(**DETECT)
    s0, d0 = model(img0[None])
    s1, d1 = model(img1[None])
    k0, v0 = detection(s0[0], dp)
    k1, v1 = detection(s1[0], dp)
    if d0 is None:
        return (k0, v0, k1, v1) + (None,) * 3
    m0, m1, ok = brute_force_match(k0, v0, k1, v1, d0[0], d1[0],
                                   MAX_DISTANCE)
    return k0, v0, k1, v1, m0, m1, ok


def corner_gap(H, gt, size: int) -> float:
    """The largest distance in pixels between the image corners mapped by
    H and by the ground truth gt (both [3, 3])."""
    c = np.array([[0, 0, 1], [size - 1, 0, 1], [0, size - 1, 1],
                  [size - 1, size - 1, 1]], np.float64).T
    a, b = np.asarray(H, np.float64) @ c, np.asarray(gt, np.float64) @ c
    return float(np.abs(a[:2] / a[2] - b[:2] / b[2]).max())


def run(model_name: str = "Alike", out: str = os.path.join("output", "demo"),
        size: int = 512, device: str | torch.device = "cuda") -> dict:
    """The demo: prints as examples/demo.py prints and returns
    {"keypoints": (n0, n1), "matches": n or None, "H": [3,3] or None,
    "gt": [3,3] or None, "files": [written PNGs]}."""
    dev = resolve_device(device)
    import cv2

    from keypoint_bench_tpu_torch.datasets.synthetic import \
        SyntheticHomographyDataset
    from keypoint_bench_tpu_torch.geometry.ransac import ransac_homography
    from keypoint_bench_tpu_torch.utils import visualization as vz

    os.makedirs(out, exist_ok=True)
    sample = SyntheticHomographyDataset(1, size)[0]
    img0 = torch.as_tensor(sample["image0"], device=dev)
    img1 = torch.as_tensor(sample["image1"], device=dev)
    k0, v0, k1, v1, m0, m1, ok = pipeline(load_model(model_name, dev),
                                          img0, img1)
    k0, v0, k1, v1 = (t.cpu().numpy() for t in (k0, v0, k1, v1))
    res = {"keypoints": (int(v0.sum()), int(v1.sum())), "matches": None,
           "H": None, "gt": None, "files": []}
    print(f"{model_name}: {res['keypoints'][0]} / {res['keypoints'][1]} "
          f"keypoints")

    def write(name, img):
        cv2.imwrite(os.path.join(out, name), img)
        res["files"].append(name)

    write("keypoints0.png", vz.plot_kps_error(sample["image0"], k0, v0))
    write("keypoints1.png", vz.plot_kps_error(sample["image1"], k1, v1))
    if ok is not None:
        okn = ok.cpu().numpy()
        s = size - 1
        p0 = m0.cpu().numpy()[okn, :2] * s
        p1 = m1.cpu().numpy()[okn, :2] * s
        res["matches"] = int(okn.sum())
        print(f"matches: {okn.sum()}")
        write("matches.png", vz.plot_matches(sample["image0"],
                                             sample["image1"], p0, p1))
        gen = torch.Generator(device=dev).manual_seed(0)
        H, _, _ = ransac_homography(
            torch.as_tensor(p0, device=dev), torch.as_tensor(p1, device=dev),
            torch.ones(len(p0), dtype=torch.bool, device=dev), gen)
        H = H.cpu().numpy()
        gt = sample["warp01_params"]["homography_matrix"]
        res["H"], res["gt"] = H / H[2, 2], gt / gt[2, 2]
        print("estimated H vs GT (normalized):")
        print(np.round(res["H"], 3))
        print(np.round(res["gt"], 3))
    print("outputs in", out)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog="keypoint_bench_tpu_torch.demo")
    ap.add_argument("--model", default="Alike")
    ap.add_argument("--out", default=os.path.join("output", "demo"))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    args = ap.parse_args(argv)
    run(args.model, args.out, args.size, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
