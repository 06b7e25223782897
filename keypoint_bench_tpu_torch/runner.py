"""Evaluation orchestrator (counterpart of keypoint_bench_tpu/runner.py).

Ported so far: the per-pair repeatability and MHA loops on homography
pairs (`_run_repeatability`, `_run_mha` and their per-pair records), with
the brute-force and LightGlue matchers (`_match`, deterministic LightGlue
only). Other tasks and matchers, adaptive LightGlue, the resume journal,
bf16 and the sharded batch paths raise NotImplementedError (ROADMAP.md).
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.geometry.warp import warp_points
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.models.lightglue import lightglue_match
from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection
from keypoint_bench_tpu_torch.ops.matching import brute_force_match
from keypoint_bench_tpu_torch.tasks.mha import mha_pair
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


# LightGlue weights per detector (the reference wires SuperPoint and DISK;
# the ALIKE family maps to its aliked checkpoint)
_LIGHTGLUE_WEIGHTS = {"SuperPoint": "lightglue_superpoint",
                      "DISK": "lightglue_disk",
                      "Alike": "lightglue_aliked",
                      "Alike_s2d": "lightglue_aliked"}


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
        self._init_matcher(cfg)
        self.desc_scale = 8 if cfg.model_type == "SuperPoint" else 1
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def _init_matcher(self, cfg: EvalConfig):
        """The JAX runner's matcher set-up: light_glue without weights or
        without an adapter raises, unless light_glue_params.allow_fallback
        asks for brute force (and results are tagged matcher_fallback)."""
        mp = cfg.matcher_params
        self.matcher_type = mp.get("type", "brute_force")
        if self.matcher_type not in ("brute_force", "light_glue"):
            raise _not_ported(f"matcher {self.matcher_type!r}")
        self.bf_max_distance = float(mp.get("brute_force_params", {}).get(
            "max_distance", 5.0))
        self.lightglue_params = None
        self.matcher_fallback = None
        if self.matcher_type != "light_glue":
            return
        lg = mp.get("light_glue_params", {})
        if lg.get("adaptive", False):
            raise _not_ported("light_glue_params.adaptive")
        lg_name = _LIGHTGLUE_WEIGHTS.get(cfg.model_type)
        err = None
        if lg_name is None:
            err = (f"matcher_params.type='light_glue' but no LightGlue "
                   f"adapter exists for model_type={cfg.model_type!r} "
                   f"(supported: {', '.join(_LIGHTGLUE_WEIGHTS)})")
        else:
            try:
                self.lightglue_params = load_params(lg_name, cfg.weights_dir,
                                                    self.device)
            except FileNotFoundError as e:
                err = (f"matcher_params.type='light_glue' but the "
                       f"{lg_name!r} weights are not available: {e}")
        if err is None:
            return
        if not lg.get("allow_fallback", False):
            raise RuntimeError(
                err + ". Set matcher_params.light_glue_params.allow_fallback:"
                " true to run brute-force instead (results will be tagged "
                "matcher_fallback).")
        warnings.warn(err + " — falling back to brute_force; results tagged "
                      "matcher_fallback.")
        self.matcher_fallback = "brute_force"

    @torch.inference_mode()
    def detect(self, image: np.ndarray):
        """One HWC image (float in [0,1] or uint8) -> (score [H,W,1],
        desc map [H/s,W/s,D], kpts [K,3], valid [K])."""
        img = torch.as_tensor(np.ascontiguousarray(image),
                              device=self.device)
        score, desc = self.model(img[None])
        kpts, valid = detection(score[0], self.detect_params)
        return score[0], desc[0], kpts, valid

    def _warp(self, kpts, valid, wp):
        if wp["mode"] != "homo":
            raise _not_ported(f"warp mode {wp['mode']!r}")
        return warp_points(kpts, valid, wp)

    @torch.inference_mode()
    def _match(self, kpts0, valid0, kpts1, valid1, desc0, desc1, w, h):
        """(m_pts0 [K,3], m_pts1 [K,3], mask [K]) in normalized coords."""
        if self.lightglue_params is not None:
            return lightglue_match(self.lightglue_params, kpts0, valid0,
                                   kpts1, valid1, desc0, desc1, w, h,
                                   self.desc_scale)
        return brute_force_match(kpts0, valid0, kpts1, valid1, desc0, desc1,
                                 self.bf_max_distance)

    def run(self) -> dict:
        ds = get_dataset(self.cfg.data_params)
        task = self.cfg.task_type
        fn = {"repeatability": self._run_repeatability,
              "MHA": self._run_mha}.get(task)
        if fn is None:
            raise _not_ported(f"task_type {task!r}")
        results = fn(ds)
        if self.matcher_fallback is not None:
            results["matcher_fallback"] = self.matcher_fallback
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        with open(os.path.join(self.cfg.output_dir, "results.json"),
                  "w") as f:
            json.dump({k: v for k, v in results.items()
                       if isinstance(v, (int, float, str, list))}, f,
                      indent=2, default=float)
        return results

    def _rep_pair_record(self, batch, th: float):
        """Per-pair repeatability record and the detections it used."""
        _, _, _, _, k0, v0, _, _, k1, v1 = self._pair_maps(batch)
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

    def _pair_maps(self, batch):
        """Detections of one pair; uint8 frames are normalized in the model
        (the JAX per-pair path's missing /255 is not copied)."""
        img0 = _crop32(np.asarray(batch["image0"]))
        img1 = _crop32(np.asarray(batch["image1"]))
        return (img0, img1, *self.detect(img0), *self.detect(img1))

    def _mha_pair_record(self, batch, ths):
        """Per-pair MHA record: brute force or LightGlue on the covisible
        sets (reference MHA.py:33-39), then RANSAC-H and the corner test."""
        img0, img1, s0, d0, k0, v0, s1, d1, k1, v1 = self._pair_maps(batch)
        wp01, wp10 = batch["warp01_params"], batch["warp10_params"]
        _, _, va = self._warp(k0, v0, wp01)
        _, _, vb = self._warp(k1, v1, wp10)
        m0, m1, ok = self._match(k0, va, k1, vb, d0, d1, img0.shape[1],
                                 img0.shape[0])
        out = mha_pair(m0, m1, ok, wp01["homography_matrix"], wp01["width"],
                       wp01["height"], img0.shape[0], img0.shape[1],
                       self.generator, thresholds=ths)
        return {f"h{t:g}": float(out[k]) for k, t in enumerate(ths)}

    def _run_mha(self, ds):
        if int(self.cfg.data_params.get("batch_size", 1)) > 1:
            raise _not_ported("the sharded batch MHA path")
        if self.cfg.task_params.get("save_images"):
            raise _not_ported("task_params.save_images")
        ths = tuple(self.cfg.task_params.get("th", [3, 5, 7]))
        recs = [self._mha_pair_record(ds[i], ths) for i in range(len(ds))]
        hits = [np.array([r[f"h{t:g}"] for t in ths]) for r in recs]
        mean = np.mean(np.stack(hits), axis=0)
        result = {f"MHA@{t:g}": float(v) for t, v in zip(ths, mean)}
        for v in mean:
            print("MHA ", v)
        result["per_pair"] = [list(map(float, h)) for h in hits]
        return result


def run_eval(config: dict | EvalConfig,
             device: str | torch.device = "cuda") -> dict:
    if isinstance(config, dict):
        config = EvalConfig.from_dict(config)
    return Evaluator(config, device).run()
