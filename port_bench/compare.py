"""The check of a run's answers against the plain reference.

It has two stages, which meet at the keypoints and matches of the timed
steps (captured from the first step of each batch in the window):

1. the start: the program's keypoints and mutual-NN matches against the
   ones the reference works out from the images alone (forward, NMS and
   top-k, descriptors, matching), as the share of keypoints and of
   matches that differ;
2. the tail: every answer of the window against the reference's tail
   (warps, repeatability, RANSAC, pose) run on that batch's captured
   keypoints and matches, per pair.

The reference's own end-to-end answers are compared too, for the
record ("e2e." readings), with no limit: RANSAC on noisy matches turns a
one-keypoint difference into another winner.
"""
from __future__ import annotations

import numpy as np
import torch


def _pixel_index(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Keypoints (x, y) = ((col + 0.5) / W, (row + 0.5) / H) -> row W + col."""
    col = torch.round(k[..., 0].double() * w - 0.5).long()
    row = torch.round(k[..., 1].double() * h - 0.5).long()
    return row * w + col


def keypoints_mismatch(prog: dict, ref: dict, h: int, w: int):
    """(keypoints of the program absent from the reference's, keypoints of
    the program), over both sides of every pair; valid keypoints only."""
    miss = total = 0
    for k, v in (("k0", "v0"), ("k1", "v1")):
        pi, ri = _pixel_index(prog[k], h, w), _pixel_index(ref[k], h, w)
        for j in range(len(pi)):
            p = pi[j][prog[v][j]]
            miss += int((~torch.isin(p, ri[j][ref[v][j]])).sum())
            total += len(p)
    return miss, total


def matches_mismatch(prog: dict, ref: dict, h: int, w: int):
    """(matches of the larger set absent from the other, matches of the
    larger set), summed over the pairs; a match is the pixel pair
    (keypoint of image 0, keypoint of image 1)."""
    miss = total = 0
    hw = h * w

    def pairs(s, j):
        a = _pixel_index(s["m0"][j], h, w) * hw + _pixel_index(s["m1"][j],
                                                               h, w)
        return a[s["ok"][j]]

    for j in range(len(prog["ok"])):
        p, r = pairs(prog, j), pairs(ref, j)
        n = max(len(p), len(r))
        miss += n - int(torch.isin(p, r).sum())
        total += n
    return miss, total


def check(task, answers, prog_states, ref_states, expected, ref_outs,
          limits: dict, h: int, w: int):
    """(readings, {compared: (value, limit)}, answers outside a per-pair
    limit). answers [(batch, [outputs, B])]; the rest {batch: ...}:
    captured program states, reference states (stage 1), the tail on the
    program's states and the reference's own outputs ([outputs, B])."""
    km = kt = mm = mt = 0
    for b, ps in prog_states.items():
        m, t = keypoints_mismatch(ps, ref_states[b], h, w)
        km, kt = km + m, kt + t
        m, t = matches_mismatch(ps, ref_states[b], h, w)
        mm, mt = mm + m, mt + t
    readings = {"keypoints_mismatch": km / max(kt, 1),
                "matches_mismatch": mm / max(mt, 1)}
    per_pair, e2e, outs, refs = {}, {}, [], []
    for b, rows in answers:
        for k, g in task.per_pair_gaps(rows, expected[b]).items():
            per_pair.setdefault(k, []).append(g)
        for k, g in task.per_pair_gaps(rows, ref_outs[b]).items():
            e2e.setdefault(k, []).append(g)
        outs.append(rows)
        refs.append(ref_outs[b])
    per_pair = {k: np.concatenate(v) for k, v in per_pair.items()}
    readings.update({k: float(np.max(v)) for k, v in per_pair.items()})
    readings.update({f"e2e.{k}": float(np.max(np.concatenate(v)))
                     for k, v in e2e.items()})
    readings.update({f"e2e.{k}": v for k, v in task.aggregate_gaps(
        np.concatenate(outs, 1), np.concatenate(refs, 1)).items()})
    checks = {k: (readings[k], float(lim)) for k, lim in limits.items()}
    bad = np.zeros(sum(r.shape[1] for _, r in answers), bool)
    for k, lim in limits.items():
        if k in per_pair:
            bad |= ~(per_pair[k] <= lim)
    return readings, checks, int(bad.sum())
