"""Evaluation orchestrator (counterpart of keypoint_bench_tpu/runner.py).

Ported so far: the per-pair repeatability loop on homography and SE3
pairs, the per-pair MHA and AUC loops (`_run_repeatability`, `_run_mha`,
`_run_auc` and their per-pair records), the sequence tasks
FundamentalMatrix (per pair and `task_params.pipelined`) and
FundamentalMatrixRansac, visual_odometer (`_run_vo` pair by pair, and
`_run_vo_pipelined`, brute force through `pipeline.vo_step`, with
`task_params.ba_refine` windowed bundle adjustment) and
VisualizeTrackingError, with the brute-force, LightGlue (fixed depth, or
adaptive with `light_glue_params.adaptive`), optical_flow and
optical_flow_cv matchers (`_match`), essential RANSAC with the 8-point or
the five-point solver (`task_params.solver`), for every model of the
registry: Harris, ORB and SIFT take `model_params`, and LETNet / GoodPoint
track on their descriptor maps. Detector-only models (KeyNet, Harris, ORB,
SIFT) raise ValueError on every step that needs descriptors, where the
JAX runner fails. `precision: bfloat16` casts the model's weights
(`models.common.cast_params_bf16`) as the JAX runner does; LightGlue's
stay f32, and every path matches the descriptors the JAX runner's
per-pair and pipelined paths match (its bf16 `match_dtype` serves only
the sharded batch paths). `task_params.save_images` writes the JAX
runner's PNGs under its names (keypoint overlays in repeatability, match
overlays in MHA, AUC and the per-pair FundamentalMatrix, which adds its
epipolar lines), for the pairs a run computes; `save_metric_plot` writes
a metric curve and its txt. The images are drawn as the model saw them:
uint8 frames at /255, where the JAX runner draws them unscaled.
`data_params.batch_size > 1` runs homography repeatability, brute-force
MHA and brute-force AUC through the data-parallel steps of
`parallel/evaluate.py` (`_run_*_sharded`), and `task_params.ba_distributed`
refines VO's window with the distributed Schur solver
(`ba/distributed.py`), on the ranks of the Evaluator's mesh: the process
group's (`python -m keypoint_bench_tpu_torch.cli` under `torchrun`), or
one rank. Rank 0 alone writes progress.jsonl, results.json, images and
the trajectory; every rank returns the same results. `debug_nans: true`
runs the task under `utils.debug_nans.DebugNans`: the first operation or
kernel whose output holds a NaN raises FloatingPointError, as
`jax.debug_nans` makes the JAX runner raise.

`resume: true` re-enters a run from its `progress.jsonl` journal
(`MetricLog`) on the paths the JAX runner journals: per-pair
repeatability, MHA and AUC, and the pair-by-pair visual_odometer. A
resumed run replays the journal's records and computes only the rest. As
in the JAX runner, whose RANSAC keys come from `next_key()` only for the
pairs it computes, the generator's draws are not spent on replayed pairs,
so the RANSAC draws of the pairs after the cut differ from an uncut run's
(MHA, AUC and VO; repeatability draws nothing).
"""
from __future__ import annotations

import contextlib
import json
import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from keypoint_bench_tpu_torch.datasets import get_dataset
from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.geometry.warp import warp_points
from keypoint_bench_tpu_torch.models import PARAM_MODELS, get_model
from keypoint_bench_tpu_torch.models.common import to_float_image
from keypoint_bench_tpu_torch.models.lightglue import lightglue_match
from keypoint_bench_tpu_torch.models.lightglue_adaptive import \
    lightglue_forward_adaptive
from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection
from keypoint_bench_tpu_torch.ops.grid_sample import sample_at_points
from keypoint_bench_tpu_torch.ops.lk import (LKParams, optical_flow,
                                             optical_flow_batch,
                                             optical_flow_cv)
from keypoint_bench_tpu_torch.ops.matching import (brute_force_match,
                                                   mutual_nn_match, take_rows)
from keypoint_bench_tpu_torch.parallel.evaluate import (block,
                                                        sharded_auc_step,
                                                        sharded_eval_step,
                                                        sharded_mha_step)
from keypoint_bench_tpu_torch.parallel.mesh import Mesh, world_mesh
from keypoint_bench_tpu_torch.pipeline import detect_frames, vo_step
from keypoint_bench_tpu_torch.tasks.auc import (estimate_pose_pair, pose_auc,
                                              pose_error)
from keypoint_bench_tpu_torch.tasks.fundamental import (
    fundamental_metrics, fundamental_ransac_ratio)
from keypoint_bench_tpu_torch.tasks.mha import mha_pair
from keypoint_bench_tpu_torch.tasks.repeatability import repeatability_pair
from keypoint_bench_tpu_torch.tasks.vo import (chain_poses, vo_pair_pose,
                                               write_kitti_trajectory)
from keypoint_bench_tpu_torch.utils.debug_nans import DebugNans
from keypoint_bench_tpu_torch.weights import load_params
from keypoint_bench_tpu_torch.weights.io import check_precision


def _crop32(img: np.ndarray) -> np.ndarray:
    """Crop H, W down to multiples of 32 (reference test_step)."""
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % 32, : w - w % 32]


# a pair's two images as the batch paths stack them
_IMAGES = (lambda s: _crop32(np.asarray(s["image0"])),
           lambda s: _crop32(np.asarray(s["image1"])))


def _stack(samples, *getters) -> tuple:
    """The batch of `samples` as one numpy array a getter."""
    return tuple(np.stack([np.asarray(g(s)) for s in samples])
                 for g in getters)


def _to_host(out):
    """A step's per-pair outputs (a tensor, or a tuple / dict of them) on
    the host, each moved once."""
    if isinstance(out, dict):
        return {k: v.cpu() for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(v.cpu() for v in out)
    return out.cpu()


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


_MATCHERS = ("brute_force", "light_glue", "optical_flow", "optical_flow_cv")
# models that track on their 3-channel local descriptor maps
_DESC_FLOW_MODELS = ("LETNet", "GoodPoint")


class MetricLog:
    """Incremental per-sample metric journal enabling crash resume: the
    port's copy of the JAX runner's, with the same `progress.jsonl`
    format (a `{"meta": ...}` line, then one `{"i": ..., ...}` line a
    pair)."""

    def __init__(self, output_dir: str, resume: bool,
                 meta: dict | None = None):
        """`meta` guards resume against config drift: the journal's first
        line records it, and a resume whose meta differs (e.g. MHA `th` list
        changed) discards the journal instead of replaying records whose
        keys/values no longer mean the same thing."""
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "progress.jsonl")
        self.done: dict[int, dict] = {}
        keep = False
        if resume and os.path.exists(self.path):
            journal_meta = None
            recs = []
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if "meta" in rec:
                        journal_meta = rec["meta"]
                    elif "i" in rec:
                        recs.append(rec)
            if meta is None or journal_meta == meta:
                keep = True
                self.done = {rec["i"]: rec for rec in recs}
        if not keep and os.path.exists(self.path):
            os.remove(self.path)
        self._f = open(self.path, "a")
        if not keep and meta is not None:
            self._f.write(json.dumps({"meta": meta}) + "\n")
            self._f.flush()
        self._pending: list[tuple[int, dict]] = []

    def get(self, i: int):
        return self.done.get(i)

    # Values may be device scalars: conversion (float()) waits for the
    # device, so writes lag by `_FLUSH_DEPTH` pairs and the device runs
    # ahead while older results drain (a crash loses at most that many
    # journal lines, which simply recompute on resume).
    _FLUSH_DEPTH = 8

    def put(self, i: int, rec: dict):
        self._pending.append((i, rec))
        while len(self._pending) > self._FLUSH_DEPTH:
            self._write(*self._pending.pop(0))
        return rec

    def _write(self, i: int, rec: dict):
        rec = {"i": i, **{k: (v if isinstance(v, (str, int, list, bool))
                              else float(v)) for k, v in rec.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        for i, rec in self._pending:
            self._write(i, rec)
        self._pending = []
        self._f.close()


class ReplayLog:
    """What a rank other than 0 holds in place of the journal: rank 0's
    records to replay, and nothing written."""

    def __init__(self, done: dict):
        self.done = done

    def get(self, i: int):
        return self.done.get(i)

    def put(self, i: int, rec: dict):
        return rec

    def close(self):
        pass


def _plot_image(img) -> np.ndarray:
    """A frame as the drawing helpers take it: float32 [H,W,C] in [0, 1]
    on the host (uint8 at /255; a tensor is moved off the device)."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


class Evaluator:
    def __init__(self, cfg: EvalConfig, device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        """`mesh`: the ranks this Evaluator runs with (one rank each), by
        default the initialized process group's (`parallel.mesh.
        world_mesh`), or this rank alone."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else world_mesh(self.device)
        if self.mesh.n_model != 1:
            raise ValueError("the Evaluator runs on a 'data'-only mesh")
        self.writes = self.mesh.rank == 0    # files and prints: rank 0
        check_precision(cfg.precision)
        if cfg.model_type in PARAM_MODELS:
            self.params = dict(cfg.model_params or {})
        else:
            self.params = load_params(cfg.model_type, cfg.weights_dir,
                                      self.device, cfg.precision)
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
        self._seq_cache = None      # (batch, (frame, detections)) of _seq_maps

    def _init_matcher(self, cfg: EvalConfig):
        """The JAX runner's matcher set-up: light_glue without weights or
        without an adapter raises, unless light_glue_params.allow_fallback
        asks for brute force (and results are tagged matcher_fallback)."""
        mp = cfg.matcher_params
        self.matcher_type = mp.get("type", "brute_force")
        if self.matcher_type not in _MATCHERS:
            # the JAX runner matches by brute force under any other label;
            # the port names the ones it knows instead
            raise ValueError(f"unknown matcher_params.type "
                             f"{self.matcher_type!r}; known: "
                             f"{', '.join(_MATCHERS)}")
        self.bf_max_distance = float(mp.get("brute_force_params", {}).get(
            "max_distance", 5.0))
        of = mp.get("optical_flow_params", {})
        # `interation` is the reference config's own spelling
        self.lk_params = LKParams(
            distance=float(of.get("distance", 3)),
            win_size=int(of.get("win_size", 3)),
            levels=int(of.get("levels", 1)),
            iterations=int(of.get("interation", of.get("iterations", 40))))
        self.lightglue_params = None
        self.lightglue_forward = None
        self.matcher_fallback = None
        if self.matcher_type != "light_glue":
            return
        lg = mp.get("light_glue_params", {})
        if lg.get("adaptive", False):
            # the reference's default mode: early exit and width pruning
            self.lightglue_forward = lightglue_forward_adaptive
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
    def detect(self, image):
        """One HWC image (float in [0,1] or uint8; numpy, or a tensor on
        the device) -> (score [H,W,1], desc map [H/s,W/s,D] or None for a
        detector-only model, kpts [K,3], valid [K])."""
        img = image if isinstance(image, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(image), device=self.device)
        score, desc = self.model(img[None])
        kpts, valid = detection(score[0], self.detect_params)
        return score[0], None if desc is None else desc[0], kpts, valid

    def _descriptors(self, *descs):
        """`descs` as they are; raises ValueError, naming the model, where
        one is None (a detector-only model on a step that matches
        descriptors, which the JAX runner fails on)."""
        if any(d is None for d in descs):
            raise ValueError(
                f"model_type={self.cfg.model_type!r} is a detector without "
                f"descriptors; {self.cfg.task_type} with matcher "
                f"{self.matcher_type!r} needs descriptors (use "
                f"optical_flow on a sequence task, or repeatability)")
        return descs

    def _warp(self, kpts, valid, wp):
        return warp_points(kpts, valid, wp)

    @torch.inference_mode()
    def _match(self, kpts0, valid0, kpts1, valid1, desc0, desc1, w, h,
               imgs=None):
        """(m_pts0 [K,3], m_pts1 [K,>=2], mask [K]) in normalized coords.
        The optical-flow matchers track kpts0 from imgs[0] into imgs[1]
        (float [H,W,C] tensors)."""
        if self.lightglue_params is not None:
            return lightglue_match(self.lightglue_params, kpts0, valid0,
                                   kpts1, valid1, desc0, desc1, w, h,
                                   self.desc_scale, self.lightglue_forward)
        src0, src1 = imgs if imgs is not None else self._descriptors(
            desc0, desc1)
        if self.matcher_type == "optical_flow":
            tracked, _ = optical_flow(src0, src1, kpts0[:, 0:2],
                                      kpts0[:, 0:2], self.generator,
                                      self.lk_params)
            return kpts0, tracked, valid0
        if self.matcher_type == "optical_flow_cv":
            # cv2's LK on the host with its status filter
            tracked, status = optical_flow_cv(
                src0.cpu().numpy(), src1.cpu().numpy(), kpts0.cpu().numpy(),
                kpts0.cpu().numpy(), win_size=self.lk_params.win_size,
                levels=self.lk_params.levels)
            return kpts0, torch.as_tensor(tracked, device=self.device), \
                valid0 & torch.as_tensor(status == 1, device=self.device)
        desc0, desc1 = self._descriptors(desc0, desc1)
        return brute_force_match(kpts0, valid0, kpts1, valid1, desc0, desc1,
                                 self.bf_max_distance)

    def run(self) -> dict:
        ds = get_dataset(self.cfg.data_params)
        task = self.cfg.task_type
        fn = {"repeatability": self._run_repeatability,
              "MHA": self._run_mha,
              "FundamentalMatrix": self._run_fundamental,
              "FundamentalMatrixRansac": self._run_fundamental_ransac,
              "AUC": self._run_auc,
              "visual_odometer": self._run_vo,
              "VisualizeTrackingError": self._run_tracking_error,
              }.get(task)
        if fn is None:
            raise ValueError(f"unknown task_type {task!r}")
        with DebugNans() if self.cfg.debug_nans else contextlib.nullcontext():
            results = fn(ds)
        if self.matcher_fallback is not None:
            results["matcher_fallback"] = self.matcher_fallback
        if self.writes:
            os.makedirs(self.cfg.output_dir, exist_ok=True)
            with open(os.path.join(self.cfg.output_dir, "results.json"),
                      "w") as f:
                json.dump({k: v for k, v in results.items()
                           if isinstance(v, (int, float, str, list))}, f,
                          indent=2, default=float)
        return results

    def _say(self, *args):
        if self.writes:
            print(*args)

    def _metric_log(self, meta: dict | None = None):
        """The resume journal: rank 0's MetricLog; the other ranks replay
        its records (sent by rank 0) and write nothing."""
        log = None
        if self.writes:
            log = MetricLog(self.cfg.output_dir, self.cfg.resume, meta)
        if self.mesh.world_size == 1:
            return log
        done = self.mesh.broadcast_json(
            {str(i): r for i, r in log.done.items()} if log else None)
        return log or ReplayLog({int(i): r for i, r in done.items()})

    def _batch_seeds(self, b: int) -> list:
        """One RANSAC seed a pair of a batch, drawn from the generator,
        the same on every rank (parallel/evaluate.py `pair_samples`)."""
        return torch.randint(0, 2 ** 31 - 1, (b,), generator=self.generator,
                             device=self.device).tolist()

    def _sharded_sparse_opts(self):
        """(sparse, match_dtype) of the sharded steps (JAX runner.py:
        297-308): Alike_s2d takes the sparse sampler (kernel B) unless
        task_params.sparse_desc is false; bfloat16 runs match its sparse
        descriptors in bf16."""
        sparse = (self.cfg.model_type == "Alike_s2d"
                  and bool(self.cfg.task_params.get("sparse_desc", True)))
        match_dtype = torch.bfloat16 if (
            sparse and self.cfg.precision == "bfloat16") else None
        return sparse, match_dtype

    def _sharded_records(self, ds, log, make_step, inputs, records, tail):
        """Every pair's record on a sharded batch path (JAX runner.py:
        443-504): the journal's where it has one; the others
        `batch_size` at a time, each data rank loading and computing its
        contiguous block of the batch (`make_step(mesh).shard(*inputs(
        samples), seeds)`; `records(out, j)` is pair j's record of the
        gathered outputs); a ragged tail that fills no batch pair by pair
        (`tail(sample)`) on every rank. The mesh holds as many ranks as
        divide the batch size (JAX `_sharded_mesh`); the ranks outside it
        get the records from rank 0. Closes the log. Returns (the records
        in pair order, the number of data ranks)."""
        b = int(self.cfg.data_params.get("batch_size", 1))
        n_data = max(d for d in range(1, self.mesh.n_data + 1) if b % d == 0)
        mesh = self.mesh.subset(n_data)
        step = make_step(mesh) if mesh is not None else None
        recs: dict[int, dict] = {}
        buf: list[int] = []
        try:
            for i in range(len(ds)):
                rec = log.get(i)
                if rec is not None:
                    recs[i] = rec
                    continue
                buf.append(i)
                if len(buf) < b:
                    continue
                seeds = self._batch_seeds(b)
                if step is not None:
                    sl = block(mesh, b)
                    out = _to_host(step.shard(
                        *inputs([ds[j] for j in buf[sl]]), seeds[sl]))
                    for j, i_b in enumerate(buf):
                        recs[i_b] = log.put(i_b, records(out, j))
                buf = []
            for i in buf:   # ragged tail: per pair
                recs[i] = log.put(i, tail(ds[i]))
        finally:
            log.close()
        if n_data < self.mesh.world_size:
            recs = {int(i): r for i, r in self.mesh.broadcast_json(
                {str(i): r for i, r in recs.items()}).items()}
        return [recs[i] for i in sorted(recs)], n_data

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

    @staticmethod
    def _stack_homo_batch(samples):
        """(imgs0, imgs1, Hs, Hinvs, sizes, scales) of homography pairs."""
        return _stack(samples, *_IMAGES,
                      lambda s: s["warp01_params"]["homography_matrix"],
                      lambda s: s["warp10_params"]["homography_matrix"],
                      lambda s: [float(s["warp01_params"]["width"]),
                                 float(s["warp01_params"]["height"])],
                      lambda s: float(s["warp01_params"].get(
                          "resize", s["warp01_params"]["width"])))

    def _rep_result(self, recs, sharded=""):
        reps = [float(r["repeatability"]) for r in recs]
        errs = np.asarray([float(r["mean_error"]) for r in recs])
        result = {
            "repeatability": float(np.mean(reps)) if reps else float("nan"),
            "rep_mean_err": float(np.mean(errs[~np.isnan(errs)]))
            if len(errs) else float("nan"),
            "num_feat": float(np.mean([float(r["num_feat"]) for r in recs]))
            if recs else float("nan"),
            "per_pair_repeatability": reps,
        }
        self._say("repeatability", result["repeatability"],
                  " rep_mean_err", result["rep_mean_err"], *(
                      [sharded] if sharded else []))
        return result

    def _run_repeatability_sharded(self, ds):
        """The data-parallel batch path of homography pairs
        (data_params.batch_size > 1; JAX runner.py:443-504): the ragged
        tail runs per pair, so the means cover every pair."""
        th = float(self.cfg.task_params.get("th", 3.0))
        sparse, match_dtype = self._sharded_sparse_opts()
        log = self._metric_log({"task": "repeatability", "th": th})

        def tail(sample):
            rec = self._rep_pair_record(sample, th)[0]
            return {k: float(v) for k, v in rec.items()}

        recs, n_data = self._sharded_records(
            ds, log, lambda mesh: sharded_eval_step(
                mesh, self.model, self.detect_params, th=th,
                bf_max_distance=self.bf_max_distance, sparse=sparse,
                match_dtype=match_dtype),
            self._stack_homo_batch,
            lambda out, j: {k: float(out[k][j]) for k in (
                "repeatability", "mean_error", "num_feat")}, tail)
        return self._rep_result(recs, f"(sharded, {n_data} ranks)")

    def _run_repeatability(self, ds):
        # the sharded path stacks homography warps only; SE3 pairs run the
        # per-pair loop whatever the batch size
        if int(self.cfg.data_params.get("batch_size", 1)) > 1 and \
                len(ds) > 0 and ds[0]["warp01_params"]["mode"] == "homo":
            return self._run_repeatability_sharded(ds)
        th = float(self.cfg.task_params.get("th", 3.0))
        log = self._metric_log({"task": "repeatability", "th": th})

        def record(i, batch):
            rec, (k0, v0, k1, v1) = self._rep_pair_record(batch, th)
            if self.cfg.task_params.get("save_images"):
                # keypoint overlays like the reference writes per pair
                # (tasks/repeatability.py:117-121), behind a flag
                self._dump_keypoints(i, batch["image0"], k0, v0, 0)
                self._dump_keypoints(i, batch["image1"], k1, v1, 1)
            return rec

        return self._rep_result(self._journaled(log, ds, record))

    @staticmethod
    def _journaled(log: MetricLog, ds, record) -> list[dict]:
        """Every pair's record: the journal's where it has one (the pair is
        not loaded), else `record(i, ds[i])`, journaled; closes the log,
        also when a pair raises (what was computed stays for a resume)."""
        recs = []
        try:
            for i in range(len(ds)):
                rec = log.get(i)
                if rec is None:
                    rec = log.put(i, record(i, ds[i]))
                recs.append(rec)
        finally:
            log.close()
        return recs

    def _pair_maps(self, batch):
        """Detections of one pair; uint8 frames are normalized in the model
        (the JAX per-pair path's missing /255 is not copied)."""
        img0 = _crop32(np.asarray(batch["image0"]))
        img1 = _crop32(np.asarray(batch["image1"]))
        return (img0, img1, *self.detect(img0), *self.detect(img1))

    def save_metric_plot(self, values, name):
        """Per-pair metric curve + txt like the reference's plot_* helpers
        (needs matplotlib)."""
        from keypoint_bench_tpu_torch.utils.visualization import plot_series
        if not self.writes:
            return
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        plot_series(values, os.path.join(self.cfg.output_dir, f"{name}.png"))

    def _dump_keypoints(self, i, image, kpts, valid, side):
        """Repeatability's keypoint overlay of one side of pair i."""
        if not self.writes:
            return
        import cv2
        from keypoint_bench_tpu_torch.utils.visualization import \
            plot_kps_error
        show = plot_kps_error(_plot_image(image), kpts.cpu().numpy(),
                              valid.cpu().numpy())
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        cv2.imwrite(os.path.join(self.cfg.output_dir,
                                 f"{i}_repeatability_{side}.png"), show)

    def _dump_matches(self, i, tag, img0, img1, m0, m1, ok):
        """Flag-gated per-pair match overlay, like the reference writes
        behind save_result (FundamentalMatrix.py:25-48, AUC.py:146-148)."""
        if not self.writes:
            return
        import cv2
        from keypoint_bench_tpu_torch.utils.visualization import plot_matches
        img0, img1 = _plot_image(img0), _plot_image(img1)
        okn = ok.cpu().numpy()
        s0 = np.asarray([img0.shape[1] - 1.0, img0.shape[0] - 1.0])
        s1 = np.asarray([img1.shape[1] - 1.0, img1.shape[0] - 1.0])
        p0 = m0.cpu().numpy()[:, :2] * s0
        p1 = m1.cpu().numpy()[:, :2] * s1
        show = plot_matches(img0, img1, p0[okn], p1[okn])
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        cv2.imwrite(os.path.join(self.cfg.output_dir, f"{tag}_{i}.png"),
                    show)

    def _mha_pair_record(self, i, batch, ths):
        """Per-pair MHA record: brute force or LightGlue on the covisible
        sets (reference MHA.py:33-39), then RANSAC-H and the corner test;
        with save_images, pair i's match overlay (none for i None, the
        sharded path's tail, as in the JAX runner)."""
        img0, img1, s0, d0, k0, v0, s1, d1, k1, v1 = self._pair_maps(batch)
        wp01, wp10 = batch["warp01_params"], batch["warp10_params"]
        _, _, va = self._warp(k0, v0, wp01)
        _, _, vb = self._warp(k1, v1, wp10)
        m0, m1, ok = self._match(k0, va, k1, vb, d0, d1, img0.shape[1],
                                 img0.shape[0])
        if self.cfg.task_params.get("save_images") and i is not None:
            self._dump_matches(i, "mha_matches", img0, img1, m0, m1, ok)
        out = mha_pair(m0, m1, ok, wp01["homography_matrix"], wp01["width"],
                       wp01["height"], img0.shape[0], img0.shape[1],
                       self.generator, thresholds=ths)
        return {f"h{t:g}": float(out[k]) for k, t in enumerate(ths)}

    def _mha_result(self, recs, ths):
        hits = [np.array([float(r[f"h{t:g}"]) for t in ths]) for r in recs]
        mean = np.mean(np.stack(hits), axis=0) if hits \
            else np.full(len(ths), np.nan)
        result = {f"MHA@{t:g}": float(v) for t, v in zip(ths, mean)}
        for v in mean:
            self._say("MHA ", v)
        result["per_pair"] = [list(map(float, h)) for h in hits]
        return result

    def _run_mha_sharded(self, ds):
        """The data-parallel batch path of brute-force MHA (JAX runner.py:
        598-654); the ragged tail runs per pair."""
        ths = tuple(float(t) for t in self.cfg.task_params.get(
            "th", [3, 5, 7]))
        sparse, match_dtype = self._sharded_sparse_opts()
        log = self._metric_log({"task": "MHA", "th": list(ths)})
        recs, _ = self._sharded_records(
            ds, log, lambda mesh: sharded_mha_step(
                mesh, self.model, self.detect_params, ths,
                bf_max_distance=self.bf_max_distance, sparse=sparse,
                match_dtype=match_dtype),
            lambda samples: self._stack_homo_batch(samples)[:5],
            lambda hits, j: {f"h{t:g}": float(hits[j, k])
                             for k, t in enumerate(ths)},
            lambda sample: self._mha_pair_record(None, sample, ths))
        return self._mha_result(recs, ths)

    def _run_mha(self, ds):
        # the sharded path serves brute force alone; every other matcher
        # runs the per-pair loop whatever the batch size
        if int(self.cfg.data_params.get("batch_size", 1)) > 1 and \
                self.matcher_type == "brute_force":
            return self._run_mha_sharded(ds)
        ths = tuple(self.cfg.task_params.get("th", [3, 5, 7]))
        log = self._metric_log({"task": "MHA",
                                "th": [float(t) for t in ths]})
        recs = self._journaled(log, ds, lambda i, batch: self._mha_pair_record(
            i, batch, ths))
        return self._mha_result(recs, ths)

    def _auc_pair_record(self, i, batch):
        """Per-pair AUC record (reference AUC.py:40-155): match, essential
        RANSAC + recoverPose on the intrinsics-normalized matches, pose
        error; a failed pair counts 180 degrees and 0 inliers. With
        save_images, pair i's match overlay (AUC.py:146-148; none for i
        None, the sharded path's tail)."""
        img0, img1, s0, d0, k0, v0, s1, d1, k1, v1 = self._pair_maps(batch)
        wp01 = batch["warp01_params"]
        m0, m1, ok = self._match(k0, v0, k1, v1, d0, d1, img0.shape[1],
                                 img0.shape[0])
        if self.cfg.task_params.get("save_images") and i is not None:
            self._dump_matches(i, "auc_matches", img0, img1, m0, m1, ok)
        h0, w0 = img0.shape[0], img0.shape[1]
        h1, w1 = img1.shape[0], img1.shape[1]
        dev = self.device
        p0 = m0[:, 0:2] * torch.tensor([w0 - 1.0, h0 - 1.0], device=dev)
        p1 = m1[:, 0:2] * torch.tensor([w1 - 1.0, h1 - 1.0], device=dev)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        R, t, _, n_in, okp = estimate_pose_pair(
            p0, p1, ok, f32(wp01["intrinsics0"]), f32(wp01["intrinsics1"]),
            self.generator,
            solver=self.cfg.task_params.get("solver", "8pt"))
        err = pose_error(R, t, f32(wp01["pose01"]))
        return {"error": float(err) if bool(okp) else 180.0,
                "inliers": int(n_in) if bool(okp) else 0}

    def _auc_result(self, recs):
        ths = tuple(self.cfg.task_params.get("th", [5, 10, 20]))
        errors = [float(r["error"]) for r in recs]
        inliers = [float(r["inliers"]) for r in recs]
        aucs = pose_auc(errors, ths)
        result = {f"AUC@{t}": float(a) for t, a in zip(ths, aucs)}
        result["AUC_inliers"] = float(np.mean(inliers)) if inliers else 0.0
        for a in aucs:
            self._say("AUC ", a)
        self._say("AUC inliers", result["AUC_inliers"])
        result["per_pair_error"] = errors
        return result

    def _run_auc_sharded(self, ds):
        """The data-parallel batch path of brute-force AUC (JAX runner.py:
        697-769): the images of a batch share one shape; the ragged tail
        runs per pair, so the error list covers every pair."""
        solver = self.cfg.task_params.get("solver", "8pt")
        sparse, match_dtype = self._sharded_sparse_opts()
        log = self._metric_log({"task": "AUC", "solver": solver})

        def inputs(samples):
            return _stack(samples, *_IMAGES, *(
                lambda s, k=k: s["warp01_params"][k]
                for k in ("intrinsics0", "intrinsics1", "pose01")))

        recs, _ = self._sharded_records(
            ds, log, lambda mesh: sharded_auc_step(
                mesh, self.model, self.detect_params, solver=solver,
                bf_max_distance=self.bf_max_distance, sparse=sparse,
                match_dtype=match_dtype),
            inputs,
            lambda out, j: {"error": float(out[0][j]),
                            "inliers": int(out[1][j])},
            lambda sample: self._auc_pair_record(None, sample))
        return self._auc_result(recs)

    def _run_auc(self, ds):
        # the sharded path serves brute force alone; every other matcher
        # runs the per-pair loop whatever the batch size
        if int(self.cfg.data_params.get("batch_size", 1)) > 1 and \
                self.matcher_type == "brute_force":
            return self._run_auc_sharded(ds)
        log = self._metric_log({"task": "AUC",
                                "solver": self.cfg.task_params.get("solver",
                                                                   "8pt")})
        return self._auc_result(self._journaled(log, ds,
                                                self._auc_pair_record))

    def _iter_sequence(self, ds):
        """Frame-delay pairing for sequence datasets: yields (prev_batch,
        batch), starting with (b0, b0)."""
        last = None
        for batch in _iter(ds):
            if last is None:
                last = batch
            yield last, batch
            last = batch

    def _frame(self, batch) -> torch.Tensor:
        """A sequence frame on the device as float [H,W,C]; uint8 frames
        are normalized (the JAX per-pair path's missing /255 is not
        copied)."""
        return to_float_image(torch.as_tensor(
            np.ascontiguousarray(batch["image0"]), device=self.device))

    def _seq_maps(self, last, cur):
        """Detections of (prev, cur); the prev frame's come from a one-frame
        cache filled by the previous step."""
        if self._seq_cache is not None and self._seq_cache[0] is last:
            img0, maps0 = self._seq_cache[1]
        else:
            img0 = self._frame(last)
            maps0 = self.detect(img0)
        img1 = self._frame(cur)
        maps1 = self.detect(img1)
        self._seq_cache = (cur, (img1, maps1))
        return (img0, img1, *maps0, *maps1)

    def _flow_sources(self, img0, img1, d0, d1):
        """LK tracks on the raw images, except for the models that track
        on their 3-channel local descriptor maps (reference
        model_interface.py:261-273)."""
        if self.cfg.model_type in _DESC_FLOW_MODELS:
            return d0, d1
        return img0, img1

    def _fundamental_result(self, errs, radios, nums):
        result = {
            "fundamental_error": float(np.mean(errs)),
            "fundamental_radio": float(np.mean(radios)),
            "fundamental_num": float(np.mean(nums)),
            "per_frame_error": [float(e) for e in errs],
        }
        self._say("fundamental_error", result["fundamental_error"],
                  " fundamental_radio", result["fundamental_radio"],
                  " fundamental_num", result["fundamental_num"])
        return result

    @torch.inference_mode()
    def _run_fundamental_pipelined(self, ds):
        """Batched FundamentalMatrix (task_params.pipelined): one detection
        pass over all frames, then every consecutive pair's track or match
        and its epipolar metric as one batch on the device. Serves
        optical_flow (kernel F) and brute_force (kernel D)."""
        if self.matcher_type not in ("optical_flow", "brute_force"):
            raise ValueError(f"the pipelined FundamentalMatrix run serves "
                             f"optical_flow and brute_force, not "
                             f"{self.matcher_type!r}")
        th = float(self.cfg.task_params.get("th", 3.0))
        items = list(_iter(ds))
        raw = np.stack([np.asarray(b["image0"]) for b in items])
        Fs = torch.as_tensor(np.stack([np.asarray(b["fundamental"])
                                       for b in items]),
                             dtype=torch.float32, device=self.device)
        sparse = (self.cfg.model_type == "Alike_s2d"
                  and self.matcher_type != "optical_flow"
                  and bool(self.cfg.task_params.get("sparse_desc", True)))
        _, descs, kpts, valids = detect_frames(self.model, raw,
                                               self.detect_params,
                                               self.device, sparse)
        h, w = raw.shape[1:3]
        scale = torch.tensor([w - 1.0, h - 1.0], device=self.device)

        def shift1(x):
            """The previous frame's operand of every frame (frame 0 pairs
            with itself); None stays None (a detector-only model)."""
            return None if x is None else torch.cat([x[:1], x[:-1]])

        k0 = shift1(kpts)[:, :, 0:2]
        if self.matcher_type == "optical_flow":
            frames = to_float_image(torch.as_tensor(raw,
                                                    device=self.device))
            src0, src1 = self._flow_sources(shift1(frames), frames,
                                            shift1(descs), descs)
            tracked, _ = optical_flow_batch(src0, src1, k0, k0,
                                            self.generator, self.lk_params)
            out = fundamental_metrics(k0 * scale, tracked * scale,
                                      shift1(valids), Fs, th)
        else:
            d0, d1 = self._descriptors(shift1(descs), descs)
            if not sparse:
                d0 = sample_at_points(d0, shift1(kpts))
                d1 = sample_at_points(d1, kpts)
            nn01, ok = mutual_nn_match(d0, d1, shift1(valids), valids,
                                       self.bf_max_distance)
            k1 = take_rows(kpts, nn01)[:, :, 0:2]
            out = fundamental_metrics(k0 * scale, k1 * scale, ok, Fs, th)
        return self._fundamental_result(
            out["fundamental_error"].cpu().numpy(),
            out["fundamental_radio"].cpu().numpy(),
            out["fundamental_num"].cpu().numpy())

    @torch.inference_mode()
    def _run_fundamental(self, ds):
        # as in the JAX runner, the pipelined run writes no images
        if self.cfg.task_params.get("pipelined"):
            return self._run_fundamental_pipelined(ds)
        th = float(self.cfg.task_params.get("th", 3.0))
        errs, radios, nums = [], [], []
        for last, batch in self._iter_sequence(ds):
            img0, img1, s0, d0, k0, v0, s1, d1, k1, v1 = \
                self._seq_maps(last, batch)
            h, w = img1.shape[0], img1.shape[1]
            if self.matcher_type in ("optical_flow", "optical_flow_cv"):
                m0, m1, ok = self._match(
                    k0, v0, k1, v1, d0, d1, w, h,
                    imgs=self._flow_sources(img0, img1, d0, d1))
            else:
                m0, m1, ok = self._match(k0, v0, k1, v1, d0, d1, w, h)
            scale = torch.tensor([w - 1.0, h - 1.0], device=self.device)
            F = torch.as_tensor(np.asarray(batch["fundamental"]),
                                dtype=torch.float32, device=self.device)
            p0, p1 = m0[:, 0:2] * scale, m1[:, 0:2] * scale
            out = fundamental_metrics(p0, p1, ok, F, th)
            if self.cfg.task_params.get("save_images"):
                # reference FundamentalMatrix.py:70-84: match overlay +
                # epipolar lines of the matched points, behind save_result
                self._dump_epipolar(len(errs), img0, img1, m0, m1, p0, p1,
                                    ok, batch["fundamental"])
            errs.append(float(out["fundamental_error"]))
            radios.append(float(out["fundamental_radio"]))
            nums.append(int(out["fundamental_num"]))
        return self._fundamental_result(errs, radios, nums)

    def _dump_epipolar(self, i, img0, img1, m0, m1, p0, p1, ok, F):
        """FundamentalMatrix's images of pair i: the match overlay and the
        epipolar lines of the matched points over frame 1."""
        if not self.writes:
            return
        import cv2
        from keypoint_bench_tpu_torch.utils.visualization import \
            plot_epipolar_lines
        self._dump_matches(i, "fund_matches", img0, img1, m0, m1, ok)
        okn = ok.cpu().numpy()
        show = plot_epipolar_lines(_plot_image(img1), p0.cpu().numpy()[okn],
                                   p1.cpu().numpy()[okn], np.asarray(F))
        cv2.imwrite(os.path.join(self.cfg.output_dir,
                                 f"fund_epipolar_{i}.png"), show)

    @torch.inference_mode()
    def _run_fundamental_ransac(self, ds):
        radios = []
        for batch in _iter(ds):
            img0, _, _, d0, k0, v0, _, d1, k1, v1 = self._pair_maps(batch)
            h, w = img0.shape[0], img0.shape[1]
            m0, m1, ok = self._match(k0, v0, k1, v1, d0, d1, w, h)
            scale = torch.tensor([w - 1.0, h - 1.0], device=self.device)
            out = fundamental_ransac_ratio(m0[:, 0:2] * scale,
                                           m1[:, 0:2] * scale, ok,
                                           self.generator)
            radios.append(float(out["fundamental_radio"]))
        result = {"fundamental_radio": float(np.mean(radios))}
        self._say("fundamental_radio", result["fundamental_radio"])
        return result

    def _vo_result(self, R_est, t_est):
        """Write the KITTI trajectory (rank 0); the VO result's common
        keys."""
        traj = os.path.join(self.cfg.output_dir, "trajectory.txt")
        if self.writes:
            os.makedirs(self.cfg.output_dir, exist_ok=True)
            write_kitti_trajectory(traj, R_est, t_est)
        return {"num_frames": len(R_est) - 1, "trajectory_path": traj,
                "R_est": R_est, "t_est": t_est}

    def _run_vo_pipelined(self, ds):
        """Batched VO (task_params.pipelined, brute force):
        `pipeline.vo_step` over every frame of the sequence at once, only
        the GT-scale pose chain on the host; task_params.ba_refine grows it
        into windowed bundle adjustment (tasks/vo_ba.py)."""
        tp = self.cfg.task_params
        ba = bool(tp.get("ba_refine"))
        metas = list(_iter(ds))
        frames = np.stack([np.asarray(b["image0"]) for b in metas])
        scales = [float(np.linalg.norm(np.asarray(b["ground_truth"])[0:3, 3]
                                       - np.asarray(
                                           b["last_ground_truth"])[0:3, 3]))
                  for b in metas]
        m = metas[0]
        K = np.array([[float(m["fx"]), 0, float(m["cx"])],
                      [0, float(m["fy"]), float(m["cy"])], [0, 0, 1.0]],
                     np.float32)
        # Alike_s2d: sparse per-keypoint descriptors (the same values as
        # dense sampling, no dense map; task_params.sparse_desc opts out)
        sparse = (self.cfg.model_type == "Alike_s2d"
                  and bool(tp.get("sparse_desc", True)))
        # ba_distributed: the window refines through the distributed Schur
        # solver over the Evaluator's ranks (each runs the same VO step)
        out = vo_step(self.model, frames, K, scales, self.detect_params,
                      self.generator, self.bf_max_distance, ba_refine=ba,
                      sparse=sparse, device=self.device,
                      mesh=self.mesh if tp.get("ba_distributed") else None)
        result = self._vo_result(out["R_est"], out["t_est"])
        if "ba_tracks" in out:
            result.update({k: v for k, v in out.items()
                           if k.startswith("ba_")})
            self._say(f"BA window: {out['ba_tracks']} tracks, reproj "
                      f"{out['ba_reproj_before']:.2f} -> "
                      f"{out['ba_reproj_after']:.2f} px")
        return result

    @torch.inference_mode()
    def _run_vo(self, ds):
        """Monocular VO with GT-scale injection: pair by pair (brute force,
        LightGlue, optical_flow, optical_flow_cv), or batched for brute
        force with task_params.pipelined. Device LK has no cv2 status, so
        optical_flow keeps the tracks that land in bounds."""
        if self.cfg.task_params.get("pipelined") and \
                self.matcher_type == "brute_force":
            return self._run_vo_pipelined(ds)
        log = self._metric_log()
        rel_R, rel_t, oks, scales = [], [], [], []
        try:
            for i, (last, batch) in enumerate(self._iter_sequence(ds)):
                rec = log.get(i)
                if rec is None:
                    rec = log.put(i, self._vo_pair_record(last, batch))
                rel_R.append(np.asarray(rec["R"]).reshape(3, 3))
                rel_t.append(np.asarray(rec["t"]))
                oks.append(bool(rec["ok"]))
                scales.append(float(rec["scale"]))
        finally:
            log.close()
        R_est, t_est = chain_poses(np.stack(rel_R), np.stack(rel_t),
                                   np.asarray(oks), np.asarray(scales))
        return self._vo_result(R_est, t_est)

    def _vo_pair_record(self, last, batch) -> dict:
        """One pair's relative pose (the record the journal keeps) and the
        ground-truth scale between its frames."""
        img0, img1, s0, d0, k0, v0, s1, d1, k1, v1 = \
            self._seq_maps(last, batch)
        h, w = img1.shape[0], img1.shape[1]
        if self.matcher_type in ("optical_flow", "optical_flow_cv"):
            m0, m1, ok = self._match(
                k0, v0, k1, v1, d0, d1, w, h,
                imgs=self._flow_sources(img0, img1, d0, d1))
            if self.matcher_type == "optical_flow":
                ok = ok & ((m1[:, 0:2] >= 0) & (m1[:, 0:2] <= 1)).all(-1)
        else:
            m0, m1, ok = self._match(k0, v0, k1, v1, d0, d1, w, h)
        scale = torch.tensor([w - 1.0, h - 1.0], device=self.device)
        R, t, _, okp = vo_pair_pose(
            m0[:, 0:2] * scale, m1[:, 0:2] * scale, ok,
            float(batch["fx"]), float(batch["cx"]), float(batch["cy"]),
            self.generator)
        gt = np.asarray(batch["ground_truth"])
        gt_prev = np.asarray(batch["last_ground_truth"])
        return {"R": R.cpu().numpy().reshape(-1).tolist(),
                "t": t.cpu().numpy().tolist(), "ok": bool(okp),
                "scale": float(np.linalg.norm(gt[0:3, 3] - gt_prev[0:3, 3]))}

    @torch.inference_mode()
    def _run_tracking_error(self, ds):
        """VisualizeTrackingError (JAX runner.py:1164-1184): each pair's
        keypoints warped into frame 1 by the ground truth are the initial
        guess of LK from frame 0 into frame 1; the pair's error is the
        mean pixel distance of the tracks from the warped points over the
        covisible keypoints, 0 for a pair without a warp. The errors stay
        on the device until the last pair."""
        errs = []
        for batch in _iter(ds):
            img0, img1 = (torch.as_tensor(np.ascontiguousarray(_crop32(
                np.asarray(batch[k]))), device=self.device)
                for k in ("image0", "image1"))
            _, d0, k0, v0 = self.detect(img0)
            _, d1, _, _ = self.detect(img1)
            wp01 = batch.get("warp01_params")
            if wp01 is None:
                errs.append(torch.zeros((), device=self.device))
                continue
            src0, src1 = self._flow_sources(to_float_image(img0),
                                            to_float_image(img1), d0, d1)
            a0, a01, va = self._warp(k0, v0, wp01)
            tracked, _ = optical_flow(src0, src1, a0, a01, self.generator,
                                      self.lk_params)
            scale = torch.tensor([img0.shape[1] - 1.0, img0.shape[0] - 1.0],
                                 device=self.device)
            err = torch.linalg.vector_norm((a01 - tracked) * scale, dim=-1)
            errs.append(torch.where(va, err, torch.zeros_like(err)).sum()
                        / va.sum().clamp_min(1))
        per_pair = torch.stack(errs).cpu().tolist() if errs else []
        result = {"track_error": float(np.mean(per_pair)),
                  "per_pair": per_pair}
        self._say("track_error", result["track_error"])
        return result


def _iter(ds):
    for i in range(len(ds)):
        yield ds[i]


def run_eval(config: dict | EvalConfig,
             device: str | torch.device = "cuda") -> dict:
    if isinstance(config, dict):
        config = EvalConfig.from_dict(config)
    return Evaluator(config, device).run()
