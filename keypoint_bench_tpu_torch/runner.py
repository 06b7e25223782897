"""Evaluation orchestrator (counterpart of keypoint_bench_tpu/runner.py).

Ported so far: the per-pair repeatability loop on homography pairs
(`_run_repeatability`, `_rep_pair_record`, `_crop32`), enough to run
configs/repeatability_synthetic.yaml. Other tasks, the resume journal,
bf16 and the sharded batch path raise NotImplementedError (ROADMAP.md).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.geometry.warp import warp_points
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection
from keypoint_bench_tpu_torch.tasks.repeatability import repeatability_pair
from keypoint_bench_tpu_torch.weights import load_params


def _crop32(img: np.ndarray) -> np.ndarray:
    """Crop H, W down to multiples of 32 (reference test_step)."""
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % 32, : w - w % 32]


@dataclass
class EvalConfig:
    model_type: str
    task_type: str
    data_params: dict
    extractor_params: dict = field(default_factory=dict)
    matcher_params: dict = field(default_factory=dict)
    task_params: dict = field(default_factory=dict)
    model_params: dict = field(default_factory=dict)
    weights_dir: str | None = None
    output_dir: str = "output"
    seed: int = 0
    precision: str = "float32"
    debug_nans: bool = False
    resume: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "EvalConfig":
        return cls(**d)

    @classmethod
    def from_yaml(cls, path: str) -> "EvalConfig":
        import yaml
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to keypoint_bench_tpu_torch yet (ROADMAP.md, "
        f"Queue 1); run it with keypoint_bench_tpu")


class Evaluator:
    def __init__(self, cfg: EvalConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.precision != "float32":
            raise _not_ported(f"precision {cfg.precision!r}")
        if cfg.resume:
            raise _not_ported("resume")
        self.params = load_params(cfg.model_type, cfg.weights_dir,
                                  self.device)
        self.model = get_model(cfg.model_type)(self.params).eval()
        ep = cfg.extractor_params
        self.detect_params = DetectParams(
            nms_dist=int(ep.get("nms_dist", 4)),
            threshold=float(ep.get("threshold", 0.0)),
            border_dist=int(ep.get("border_dist", 8)),
            top_k=int(ep.get("top_k", 300)),
            min_score=float(ep.get("min_score", 0.0)))

    @torch.inference_mode()
    def detect(self, image: np.ndarray):
        """One HWC image (float in [0,1] or uint8) -> (score [H,W,1],
        desc [H,W,64], kpts [K,3], valid [K])."""
        img = torch.as_tensor(np.ascontiguousarray(image),
                              device=self.device)
        score, desc = self.model(img[None])
        kpts, valid = detection(score[0], self.detect_params)
        return score[0], desc[0], kpts, valid

    def _warp(self, kpts, valid, wp):
        if wp["mode"] != "homo":
            raise _not_ported(f"warp mode {wp['mode']!r}")
        return warp_points(kpts, valid, wp)

    def run(self) -> dict:
        ds = get_dataset(self.cfg.data_params)
        task = self.cfg.task_type
        if task != "repeatability":
            raise _not_ported(f"task_type {task!r}")
        results = self._run_repeatability(ds)
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        with open(os.path.join(self.cfg.output_dir, "results.json"),
                  "w") as f:
            json.dump({k: v for k, v in results.items()
                       if isinstance(v, (int, float, str, list))}, f,
                      indent=2, default=float)
        return results

    def _rep_pair_record(self, batch, th: float):
        """Per-pair repeatability record and the detections it used."""
        img0 = _crop32(np.asarray(batch["image0"]))
        img1 = _crop32(np.asarray(batch["image1"]))
        _, _, k0, v0 = self.detect(img0)
        _, _, k1, v1 = self.detect(img1)
        wp01, wp10 = batch["warp01_params"], batch["warp10_params"]
        a0, a01, va = self._warp(k0, v0, wp01)
        b0, b10, vb = self._warp(k1, v1, wp10)
        scale = float(wp01.get("resize", wp01["width"]))
        out = repeatability_pair(k0, v0, k1, v1, a0, a01, va,
                                 b0, b10, vb, scale, th)
        return {"repeatability": out["repeatability"],
                "mean_error": out["mean_error"],
                "num_feat": out["num_feat"]}, (k0, v0, k1, v1)

    def _run_repeatability(self, ds):
        if int(self.cfg.data_params.get("batch_size", 1)) > 1:
            raise _not_ported("the sharded batch repeatability path")
        if self.cfg.task_params.get("save_images"):
            raise _not_ported("task_params.save_images")
        th = float(self.cfg.task_params.get("th", 3.0))
        recs = [self._rep_pair_record(ds[i], th)[0] for i in range(len(ds))]
        reps = [float(r["repeatability"]) for r in recs]
        errs = np.asarray([float(r["mean_error"]) for r in recs])
        result = {
            "repeatability": float(np.mean(reps)),
            "rep_mean_err": float(np.mean(errs[~np.isnan(errs)]))
            if len(errs) else float("nan"),
            "num_feat": float(np.mean([float(r["num_feat"]) for r in recs])),
            "per_pair_repeatability": reps,
        }
        print("repeatability", result["repeatability"],
              " rep_mean_err", result["rep_mean_err"])
        return result


def run_eval(config: dict | EvalConfig,
             device: str | torch.device = "cuda") -> dict:
    if isinstance(config, dict):
        config = EvalConfig.from_dict(config)
    return Evaluator(config, device).run()
