"""Multi-rank certificates of the parallel layer (counterpart of
`__graft_entry__.py`'s `dryrun_multichip`):

    python -m keypoint_bench_tpu_torch.parallel.dryrun N [--device cpu]

runs N ranks as threads of one process over gloo groups (on one card by
default, several ranks sharing it) and prints one line a certificate,
each asserted as the JAX dryrun asserts it:
  dp     `sharded_eval_step` over N data ranks on N warped textured pairs
         at 96^2: repeatability > 0.5, mean error < 3 px, RANSAC-H
         inliers > 10;
  tp     `lightglue_forward_tp` (heads over 2 model ranks, N/2 data
         ranks) on the golden LightGlue: matches agree > 99% with the
         dense forward, scores within 1e-3;
  ba     `ba_solve_distributed` over N data ranks: its reprojection error
         at most the single-rank `ba_solve`'s + 1e-3;
  sp     `lightglue_forward_sp` (ring attention over N data ranks) on
         the golden LightGlue, where N divides both keypoint sets:
         matches equal to the dense forward's, scores within 2e-3;
  vo-ba  `refine_window(mesh=...)`: refines, within 5% of the
         single-rank refinement's error, rotations within 2e-3.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from keypoint_bench_tpu_torch.ba.distributed import (ba_solve_distributed,
                                                     gather_points)
from keypoint_bench_tpu_torch.ba.gauss_newton import (BAProblem, ba_solve,
                                                      reprojection_errors)
from keypoint_bench_tpu_torch.datasets.synthetic import (_texture,
                                                         _warp_image)
from keypoint_bench_tpu_torch.device import resolve_device
from keypoint_bench_tpu_torch.models import get_model
from keypoint_bench_tpu_torch.models.lightglue import lightglue_forward
from keypoint_bench_tpu_torch.ops.detect import DetectParams
from keypoint_bench_tpu_torch.parallel.evaluate import sharded_eval_step
from keypoint_bench_tpu_torch.parallel.lightglue_sp import \
    lightglue_forward_sp
from keypoint_bench_tpu_torch.parallel.lightglue_tp import (
    lightglue_forward_tp, shard_lightglue_params)
from keypoint_bench_tpu_torch.parallel.mesh import thread_ranks
from keypoint_bench_tpu_torch.tasks.vo_ba import refine_window
from keypoint_bench_tpu_torch.weights import load_golden_params, load_params
from keypoint_bench_tpu_torch.weights.io import GOLDEN_DIR


def textured_warped_pairs(n: int, s: int, seed: int = 0):
    """n textured pairs under mild random homographies (the synthetic
    homography dataset's recipe at size s; `__graft_entry__.py`'s)."""
    imgs0, imgs1, Hs, Hinvs = [], [], [], []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        img0 = _texture(s, s, rng)
        ang = rng.uniform(-0.08, 0.08)
        sc = rng.uniform(0.95, 1.05)
        tx, ty = rng.uniform(-4, 4, 2)
        c, si = np.cos(ang) * sc, np.sin(ang) * sc
        T = np.array([[1, 0, s / 2], [0, 1, s / 2], [0, 0, 1]])
        R = np.array([[c, -si, tx], [si, c, ty], [0, 0, 1]])
        H = (T @ R @ np.linalg.inv(T)).astype("float32")
        imgs0.append(img0)
        imgs1.append(_warp_image(img0, np.linalg.inv(H)))
        Hs.append(H)
        Hinvs.append(np.linalg.inv(H).astype("float32"))
    return (np.stack(imgs0), np.stack(imgs1), np.stack(Hs), np.stack(Hinvs))


def ba_problem(n: int, device) -> BAProblem:
    """3 cameras seeing 4n points, the points moved by 1 cm."""
    rng = np.random.default_rng(1)
    C, P = 3, 4 * n
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    pts = np.concatenate([rng.uniform(-1, 1, (P, 2)),
                          rng.uniform(4, 8, (P, 1))], axis=1)
    angs = 0.02 * np.arange(C)
    Rs = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                             [np.sin(a), np.cos(a), 0],
                             [0, 0, 1.0]]) for a in angs])
    ts = np.stack([np.array([0.2 * c, 0.0, 0.0]) for c in range(C)])
    Xc = np.einsum("cij,cpj->cpi", Rs, np.tile(pts[None], (C, 1, 1))) \
        + ts[:, None, :]
    uv = (Xc[..., :2] / Xc[..., 2:3]) * K[0, 0] + K[:2, 2]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return BAProblem(
        f32(Rs), f32(ts), f32(pts + rng.normal(0, 0.01, pts.shape)),
        torch.as_tensor(np.repeat(np.arange(C), P), device=device),
        torch.as_tensor(np.tile(np.arange(P), C), device=device),
        f32(uv.reshape(-1, 2)),
        torch.ones(C * P, dtype=torch.bool, device=device), f32(K))


def vo_window(T: int = 3, S: int = 24):
    """A T-frame window of S tracks with 0.3 px noise and moved poses."""
    rng = np.random.default_rng(7)
    pts_w = np.concatenate([rng.uniform(-1, 1, (S, 2)),
                            rng.uniform(4, 8, (S, 1))], axis=1)
    K = np.array([[120.0, 0, 48], [0, 120.0, 48], [0, 0, 1.0]], np.float32)
    angs = 0.03 * np.arange(T)
    R = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                            [np.sin(a), np.cos(a), 0],
                            [0, 0, 1.0]]) for a in angs])
    t = np.stack([np.array([0.15 * c, 0.0, 0.0]) for c in range(T)])
    Xc = np.einsum("cij,pj->cpi", R, pts_w) + t[:, None, :]
    kpts_px = ((Xc[..., :2] / Xc[..., 2:3]) * K[0, 0] + K[:2, 2]
               + rng.normal(0, 0.3, (T, S, 2)))
    tracks = [[(f, s) for f in range(T)] for s in range(S)]
    return kpts_px, tracks, R, t + rng.normal(0, 0.01, t.shape), K


def dryrun(n: int, device="cuda", log=print) -> dict:
    """The certificates on n ranks; returns their numbers by name."""
    dev = resolve_device(device)
    out = {}
    model = get_model("Alike_s2d")(load_params("Alike_s2d", device=dev))
    dp = DetectParams(nms_dist=4, border_dist=4, top_k=64, max_nms_iter=8)
    s = 96
    i0, i1, Hs, Hinvs = textured_warped_pairs(n, s)
    prob = ba_problem(n, dev)
    window = vo_window()

    def data_ranks(mesh):
        res = sharded_eval_step(mesh, model, dp)(
            i0, i1, Hs, Hinvs, np.full((n, 2), float(s)),
            np.full(n, float(s)), list(range(n)))
        Rd, td, s_pts, meta = ba_solve_distributed(mesh, prob, iters=4)
        final = BAProblem(Rd, td, gather_points(s_pts, meta, 4 * n),
                          prob.cam_idx, prob.pt_idx, prob.uv, prob.mask,
                          prob.K)
        return (res, float(reprojection_errors(final).mean()),
                refine_window(*window, iters=4, mesh=mesh, device=dev))

    res, err_dist, refd = thread_ranks(data_ranks, n, device=dev)[0]
    rep = float(res["repeatability"].mean())
    err = float(res["mean_error"].mean())
    inl = float(res["homography_inliers"].mean())
    assert rep > 0.5, f"sharded repeatability degenerate: {rep}"
    assert np.isfinite(err) and err < 3.0, f"mean_error off: {err}"
    assert inl > 10.0, f"RANSAC homography inliers degenerate: {inl}"
    out["dp"] = {"repeatability": rep, "mean_error": err,
                 "ransac_inliers": inl}
    log(f"dryrun dp ok: rep={rep:.3f} err={err:.3f} ransac_inliers="
        f"{inl:.1f} over {n} warped textured pairs on {n} data ranks")

    g = np.load(f"{GOLDEN_DIR}/lightglue.npz")
    lg = load_golden_params("lightglue", dev)
    k0, d0, k1, d1 = (torch.as_tensor(g[k][0], device=dev)
                      for k in ("kpts0", "desc0", "kpts1", "desc1"))
    args = (k0, torch.ones(len(k0), dtype=torch.bool, device=dev), d0,
            k1, torch.ones(len(k1), dtype=torch.bool, device=dev), d1)
    m0_d, ms_d, _ = lightglue_forward(lg, *args)
    if n >= 2 and n % 2 == 0:
        sp = shard_lightglue_params(lg, 2)
        m0_t, ms_t, _ = thread_ranks(
            lambda mesh: lightglue_forward_tp(mesh, sp, *args), n // 2, 2,
            device=dev)[0]
        agree = float((m0_t == m0_d).float().mean())
        max_dev = float((ms_t - ms_d).abs().max())
        assert agree > 0.99, f"tp != dense: match agreement {agree}"
        assert max_dev < 1e-3, f"tp != dense: score dev {max_dev}"
        out["tp"] = {"match_agreement": agree, "max_score_dev": max_dev}
        log(f"dryrun tp ok: heads over 2 model ranks == dense (match agree "
            f"{agree:.3f}, max score dev {max_dev:.2e})")
    if len(k0) % n == 0 and len(k1) % n == 0:
        m0_s, ms_s, _ = thread_ranks(
            lambda mesh: lightglue_forward_sp(mesh, lg, *args), n,
            device=dev)[0]
        assert bool((m0_s == m0_d).all()), "sp != dense: matches"
        max_dev = float((ms_s - ms_d).abs().max())
        assert max_dev < 2e-3, f"sp != dense: score dev {max_dev}"
        out["sp"] = {"max_score_dev": max_dev}
        log(f"dryrun sp ok: ring attention over {n} data ranks == dense "
            f"(max score dev {max_dev:.2e})")

    err_single = float(ba_solve(prob, iters=4, damping=1e-4)[3])
    assert np.isfinite(err_dist), err_dist
    assert err_dist <= err_single + 1e-3, \
        f"distributed BA worse than one rank: {err_dist} vs {err_single}"
    out["ba"] = {"err_distributed": err_dist, "err_single": err_single}
    log(f"dryrun ba ok: distributed Schur err {err_dist:.5f} <= one rank "
        f"{err_single:.5f} ({4 * n} landmarks on {n} ranks)")

    ref1 = refine_window(*window, iters=4, device=dev)
    assert ref1 is not None and refd is not None
    (R1, _, p1, _, e1_1), (Rd, _, pd, e0_d, e1_d) = ref1, refd
    assert p1.shape == pd.shape == (24, 3), (p1.shape, pd.shape)
    assert e1_d < e0_d, f"joined BA did not refine: {e0_d} -> {e1_d}"
    assert abs(e1_d - e1_1) < 0.05 * max(e1_1, 0.1), \
        f"vo-ba join != one rank: {e1_d} vs {e1_1}"
    np.testing.assert_allclose(Rd, R1, atol=2e-3)
    out["vo-ba"] = {"err_before": e0_d, "err_after": e1_d,
                    "err_single": e1_1}
    log(f"dryrun vo-ba ok: refine_window(mesh) reproj {e0_d:.4f} -> "
        f"{e1_d:.4f} px == one rank {e1_1:.4f} (24 tracks over 3 frames)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="keypoint_bench_tpu_torch.parallel."
                                      "dryrun")
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="number of ranks (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda, the "
                         "ranks sharing the card; cpu runs the plain path)")
    args = ap.parse_args(argv)
    dryrun(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
