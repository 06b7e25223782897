#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each fatal on failure:
  1. the card's name and power limit; build both CUDA kernels from
     keypoint_bench_tpu_torch/csrc with nvcc, in parallel;
  2. the ALIKE-t forward on the card vs the CPU at 128^2 (atol 1e-4, f32
     with TF32 off on both);
  3. kernel A (NMS fixpoint) vs its plain twin on real ALIKE-t score maps
     at 512^2, a tie-heavy bf16 map and a signed map: bit equality;
  4. kernel B (sparse sampler) vs its plain twin on real branch features
     at 512^2, K=1000, original and y-sorted keypoint order, and on random
     features whose last branch is 3 x 3 or 2 x 2: max abs error <= 1e-5;
  5. the main path, `extract_match` at 512^2, 16 pairs, nms 6, border 8,
     top_k 1000, max_distance 5, with the launch counts reset just before
     it: keypoints and masks equal to the same pipeline through the plain
     twins, match count within 0.5% of the valid keypoints; then timed
     (median of 7 windows) with a per-stage breakdown;
  6. synthetic repeatability (configs/repeatability_synthetic.yaml, 4
     pairs at 512^2) through the port's runner, equal to the plain-twin run;
  7. a `kernels` JSON line and, last, the device JSON line.
Exits non-zero without CUDA, or without the port's package beside it.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE, SIZE, PAIRS, K = "cuda", 512, 16, 1000
# H100 SXM peaks (vendor datasheet): HBM bytes/s, f32 FLOP/s (an FMA
# counts 2). Compares, max and adds issue at most one per f32 lane and
# clock, half the FMA-counted rate.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
PEAK_F32_OPS = PEAK_F32 / 2


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_twins():
    """Route CUDA tensors through the kernels' plain twins (the reference
    the kernels are held against); restored on exit."""
    from keypoint_bench_tpu_torch.ops import cuda_nms, cuda_sample
    from keypoint_bench_tpu_torch.ops.detect import fast_nms
    from keypoint_bench_tpu_torch.ops.sparse_desc import sample_branches
    saved = cuda_nms.nms_cuda, cuda_sample.sample_cuda
    cuda_nms.nms_cuda = fast_nms
    cuda_sample.sample_cuda = sample_branches
    try:
        yield
    finally:
        cuda_nms.nms_cuda, cuda_sample.sample_cuda = saved


def nms_bound(maps, rounds):
    """(ms, bound_by): read + write each f32 map once; the operations the
    function needs, independent of d, per pixel:
      local-max mask, 14: the row maxima of the d values left and right of
        a pixel are one width-d sliding max (van Herk / Gil-Werman, 3 max),
        the full row max 2 more, the column maxima of that over the d rows
        above and below one more sliding max (3); before/after 2,
        the strict / >= compares and their and 3, the count 1;
      suppression, 7: a box count by running sums (2 per axis), minus the
        pixel itself, a compare and a select.
    The mask runs once before the rounds, both run in every round this
    run's maps needed; all at the compare / add rate."""
    n = maps.numel()
    hw = maps.shape[-1] * maps.shape[-2]
    t_bytes = 2 * n * 4 / PEAK_BYTES
    ops = (int(rounds.sum()) * (14 + 7) + maps.shape[0] * 14) * hw
    t_ops = ops / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sample_bound(feats, px, py, h, w):
    """(ms, bound_by): the feature values this run's keypoints need (taps
    with non-zero weight, distinct per map, all channels), the coordinates
    read once and the samples written once; 2 flops per tap product."""
    import torch
    from keypoint_bench_tpu_torch.ops.sparse_desc import (_axis_taps_direct,
                                                          _axis_taps_up)
    b, k = px.shape
    nbytes = 2 * px.numel() * 4
    flops = 0
    for i, f in enumerate(feats):
        c, hi, wi = f.shape[1], f.shape[2], f.shape[3]
        if i == 0:
            rb, wr = _axis_taps_direct(py, hi)
            cb, wc = _axis_taps_direct(px, wi)
        else:
            rb, wr = _axis_taps_up(py, h, hi)
            cb, wc = _axis_taps_up(px, w, wi)
        t = wr.shape[-1]
        ar = torch.arange(t, device=px.device)
        rows = (rb[..., None] + ar)[..., :, None]
        cols = (cb[..., None] + ar)[..., None, :]
        used = (wr[..., :, None] != 0) & (wc[..., None, :] != 0)
        bidx = torch.arange(b, device=px.device)[:, None, None, None]
        lin = (bidx * hi + rows) * wi + cols
        nbytes += int(torch.unique(lin[used]).numel()) * c * 4
        nbytes += b * c * k * 4                          # the samples out
        flops += 2 * b * c * k * (t * t + t)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "keypoint_bench_tpu_torch")):
        print("chip_smoke: keypoint_bench_tpu_torch/ is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from keypoint_bench_tpu_torch.datasets import get_dataset
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.ops import _build, cuda_nms, cuda_sample
    from keypoint_bench_tpu_torch.ops.detect import (DetectParams,
                                                     detection_batch,
                                                     fast_nms,
                                                     fast_nms_rounds)
    from keypoint_bench_tpu_torch.ops.matching import mutual_nn_match
    from keypoint_bench_tpu_torch.ops.sparse_desc import (
        alike_sparse_descriptors_cm_batch_yorder, row_tap_keys,
        sample_branches)
    from keypoint_bench_tpu_torch.pipeline import extract, extract_match
    from keypoint_bench_tpu_torch.runner import EvalConfig, Evaluator
    from keypoint_bench_tpu_torch.weights import load_params

    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    torch.manual_seed(0)

    with phase("build kernels (nvcc, parallel)"):
        t0 = time.perf_counter()
        with ThreadPoolExecutor() as pool:
            list(pool.map(_build.build, ["nms", "sample"]))
        log(f"build: {time.perf_counter() - t0:.1f} s")

    params = load_params("Alike", device=dev)
    model = get_model("Alike")(params).eval()
    dp = DetectParams(nms_dist=6, border_dist=8, top_k=K)
    errs = {"nms": 0.0, "sample": 0.0}

    with phase("forward: card vs CPU at 128^2"):
        img = torch.from_numpy(np.random.default_rng(0).random(
            (1, 128, 128, 3), np.float32))
        with torch.inference_mode():
            s_gpu, d_gpu = model(img.to(dev))
            s_cpu, d_cpu = get_model("Alike")(load_params("Alike"))(img)
        err = max(float((s_gpu.cpu() - s_cpu).abs().max()),
                  float((d_gpu.cpu() - d_cpu).abs().max()))
        log(f"forward max abs err {err:.3g}")
        if not err <= 1e-4:
            raise AssertionError(f"forward card vs CPU: {err}")

    with phase("data: 16 synthetic homography pairs at 512^2"):
        ds = get_dataset({"type": "synthetic_homography",
                          "num_pairs": PAIRS, "image_size": SIZE})
        items = [ds[i] for i in range(PAIRS)]
        imgs0 = torch.from_numpy(np.stack([s["image0"] for s in items])).to(dev)
        imgs1 = torch.from_numpy(np.stack([s["image1"] for s in items])).to(dev)
        with torch.inference_mode():
            score0, feats0 = model.feats(imgs0)
        maps0 = score0[..., 0].contiguous()

    with phase("kernel A (NMS fixpoint) vs plain fast_nms"):
        bf = maps0[:1].to(torch.bfloat16)
        cases = [("score maps x8", maps0[:8], 6), ("bf16 ties", bf, 6),
                 ("signed", maps0[-2:] - 0.5, 6),
                 ("score d=2", maps0[:2], 2), ("score d=4", maps0[:2], 4)]
        for name, maps, d in cases:
            got = cuda_nms.nms_cuda(maps, d, 30)
            want = fast_nms(maps, d, 30)
            diff = float((got.float() - want.float()).abs().max())
            errs["nms"] = max(errs["nms"], diff)
            log(f"  {name}: equal={torch.equal(got, want)} "
                f"max_abs_err={diff}")
            if not torch.equal(got, want):
                raise AssertionError(f"kernel A differs on {name}")
        nms_ms = cuda_ms(lambda: cuda_nms.nms_cuda(maps0, 6, 30))
        nms_plain_ms = cuda_ms(lambda: fast_nms(maps0, 6, 30), iters=3,
                               warmup=1)
        _, rounds = fast_nms_rounds(maps0, 6, 30)
        nms_bound_ms, nms_bound_by = nms_bound(maps0, rounds)
        log(f"  [16,512,512] d=6: kernel {nms_ms:.4f} ms, plain "
            f"{nms_plain_ms:.4f} ms, bound {nms_bound_ms:.4f} ms "
            f"({nms_bound_by}); rounds per map {rounds.tolist()}")

    with phase("kernel B (sparse sampler) vs plain sampler"):
        with torch.inference_mode():
            kpts0, valid0 = detection_batch(score0, dp)
        px = (kpts0[..., 0] * (SIZE - 1.0)).contiguous()
        py = (kpts0[..., 1] * (SIZE - 1.0)).contiguous()
        order = torch.sort(row_tap_keys(kpts0, SIZE), dim=1, stable=True)[1]
        pxs, pys = px.gather(1, order), py.gather(1, order)
        for name, (x, y) in (("original order", (px, py)),
                             ("y-sorted order", (pxs, pys))):
            got = cuda_sample.sample_cuda(feats0, x, y, SIZE, SIZE)
            want = sample_branches(feats0, x, y, SIZE, SIZE)
            diff = float((got - want).abs().max())
            errs["sample"] = max(errs["sample"], diff)
            log(f"  {name}: max_abs_err={diff:.3g}")
            if not diff <= 1e-5:
                raise AssertionError(f"kernel B differs ({name}): {diff}")
        with torch.inference_mode():
            d_k, k_k, v_k = alike_sparse_descriptors_cm_batch_yorder(
                params, feats0, kpts0, valid0, SIZE, SIZE)
            with plain_twins():
                d_p, k_p, v_p = alike_sparse_descriptors_cm_batch_yorder(
                    params, feats0, kpts0, valid0, SIZE, SIZE)
        diff = float((d_k - d_p).abs().max())
        errs["sample"] = max(errs["sample"], diff)
        log(f"  yorder descriptors: max_abs_err={diff:.3g}")
        if not (diff <= 1e-5 and torch.equal(k_k, k_p)
                and torch.equal(v_k, v_p)):
            raise AssertionError(f"yorder kernel vs plain: {diff}")
        # branches of 3 and 2 rows (a 96^2 or 64^2 image's last branch):
        # the plain twin resizes them densely, the kernel takes its taps
        gen = torch.Generator(device=dev).manual_seed(1)
        for lo in (3, 2):
            sz = 32 * lo
            tiny = tuple(torch.rand((2, 16, sz // r, sz // r), device=dev,
                                    generator=gen) for r in (1, 2, 8, 32))
            tx, ty = (torch.rand((2, 300), device=dev, generator=gen)
                      * (sz - 1) for _ in range(2))
            diff = float((cuda_sample.sample_cuda(tiny, tx, ty, sz, sz)
                          - sample_branches(tiny, tx, ty, sz, sz)).abs().max())
            errs["sample"] = max(errs["sample"], diff)
            log(f"  {sz}^2 branches (last {lo}x{lo}): max_abs_err={diff:.3g}")
            if not diff <= 1e-5:
                raise AssertionError(f"kernel B differs at {sz}^2: {diff}")
        samp_ms = cuda_ms(lambda: cuda_sample.sample_cuda(
            feats0, pxs, pys, SIZE, SIZE))
        samp_plain_ms = cuda_ms(lambda: sample_branches(
            feats0, pxs, pys, SIZE, SIZE), iters=3, warmup=1)
        samp_bound_ms, samp_bound_by = sample_bound(feats0, pxs, pys, SIZE,
                                                    SIZE)
        log(f"  [16 maps, K={K}]: kernel {samp_ms:.4f} ms, plain "
            f"{samp_plain_ms:.4f} ms, bound {samp_bound_ms:.4f} ms "
            f"({samp_bound_by})")

    with phase("main path: extract_match, 16 pairs at 512^2"):
        cuda_nms.KERNEL.launches = 0
        cuda_sample.KERNEL.launches = 0
        n, k0, m1 = extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                 device=DEVICE)
        torch.cuda.synchronize()
        launches = {"nms": cuda_nms.KERNEL.launches,
                    "sample": cuda_sample.KERNEL.launches}
        log(f"  launches in one main-path run: {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched: {launches}")
        with torch.inference_mode():
            ext_k = [extract(model, params, im, dp) for im in (imgs0, imgs1)]
            with plain_twins():
                ext_p = [extract(model, params, im, dp)
                         for im in (imgs0, imgs1)]
                n_p, k0_p, m1_p = extract_match(model, params, imgs0, imgs1,
                                                dp, 5.0, device=DEVICE)
        for (dk, kk, vk), (dp_, kp, vp) in zip(ext_k, ext_p):
            if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                raise AssertionError("keypoints / masks differ from plain")
        n_valid = int(sum(e[2].sum() for e in ext_k))
        log(f"  matches kernel {int(n)} plain {int(n_p)}; valid keypoints "
            f"{n_valid}; k0 equal {torch.equal(k0, k0_p)}")
        if not torch.equal(k0, k0_p):
            raise AssertionError("k0 differs from the plain-twin pipeline")
        if abs(int(n) - int(n_p)) > 0.005 * n_valid / 2 or int(n) <= 0:
            raise AssertionError(f"match count {int(n)} vs plain {int(n_p)}")
        if not (torch.isfinite(k0).all() and torch.isfinite(m1).all()
                and k0.shape == m1.shape == (PAIRS, K, 3)):
            raise AssertionError("main-path outputs malformed")

        def step():
            return extract_match(model, params, imgs0, imgs1, dp, 5.0,
                                 device=DEVICE)

        for _ in range(2):
            step()
        windows = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / 3)
        dt = statistics.median(windows)
        fps_all = [2 * PAIRS / w for w in windows]
        log(f"  extract_match: median {dt * 1e3:.3f} ms per 16-pair batch, "
            f"{2 * PAIRS / dt:.2f} frames/s (min {min(fps_all):.2f}, max "
            f"{max(fps_all):.2f}) on {card}")
        with torch.inference_mode():
            st = {"forward (feats, 16 images)":
                  cuda_ms(lambda: model.feats(imgs0), iters=5),
                  "detection_batch (16 maps)":
                  cuda_ms(lambda: detection_batch(score0, dp), iters=5),
                  "yorder descriptors (16 maps)":
                  cuda_ms(lambda: alike_sparse_descriptors_cm_batch_yorder(
                      params, feats0, kpts0, valid0, SIZE, SIZE), iters=5),
                  "mutual_nn_match (16 pairs)":
                  cuda_ms(lambda: mutual_nn_match(
                      ext_k[0][0], ext_k[1][0], ext_k[0][2], ext_k[1][2],
                      5.0), iters=5)}
        for name, ms in st.items():
            log(f"  stage {name}: {ms:.4f} ms")

    with phase("repeatability: synthetic, 4 pairs at 512^2"):
        cfg = EvalConfig.from_yaml(os.path.join(
            ROOT, "configs", "repeatability_synthetic.yaml"))
        cfg.output_dir = os.path.join(ROOT, "output", "chip_smoke_rep")
        rep = Evaluator(cfg, DEVICE).run()
        with plain_twins():
            rep_p = Evaluator(cfg, DEVICE).run()
        log(f"  repeatability {rep['repeatability']} (plain "
            f"{rep_p['repeatability']}), rep_mean_err {rep['rep_mean_err']}")
        if not (0.0 < rep["repeatability"] <= 1.0
                and rep["per_pair_repeatability"]
                == rep_p["per_pair_repeatability"]):
            raise AssertionError("repeatability out of range or != plain")

    kernels = [
        {"name": "nms_fixpoint", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/nms.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_nms.py:87",
         "launches": launches["nms"], "max_abs_err": errs["nms"],
         "ms": nms_ms, "plain_ms": nms_plain_ms, "bound_ms": nms_bound_ms,
         "bound_by": nms_bound_by, "library_ms": None},
        {"name": "sparse_sample", "route": "cuda",
         "source": "keypoint_bench_tpu_torch/csrc/sample.cu",
         "replaces": "keypoint_bench_tpu/ops/pallas_sample.py:107",
         "launches": launches["sample"], "max_abs_err": errs["sample"],
         "ms": samp_ms, "plain_ms": samp_plain_ms, "bound_ms": samp_bound_ms,
         "bound_by": samp_bound_by, "library_ms": None},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
