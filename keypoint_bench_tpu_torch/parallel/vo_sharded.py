"""Sequence-sharded VO: the frames split into contiguous blocks over the
mesh's 'data' ranks, the boundary frame passed on by one ring hop
(counterpart of keypoint_bench_tpu/parallel/vo_sharded.py).

Pair (i-1, i) at the start of a block needs the previous block's last
frame: every rank sends its last frame's keypoints, validity and
descriptors to the next (`Mesh.ring_shift`), and rank 0 pairs its first
frame with itself. Each rank then matches its pairs in one batched call
(kernel D on CUDA) and solves them with `vo_pair_pose` (essential RANSAC +
recoverPose); the poses are gathered in frame order. Only the GT-scale
chain (`tasks/vo.chain_poses`) is sequential, on the host.
"""
from __future__ import annotations

import torch

from keypoint_bench_tpu_torch.parallel.evaluate import (block, gather_pairs,
                                                        match_block,
                                                        pair_samples)
from keypoint_bench_tpu_torch.parallel.mesh import Mesh
from keypoint_bench_tpu_torch.tasks.vo import vo_pair_pose


@torch.inference_mode()
def sharded_vo_pair_solves(mesh: Mesh, kpts, valids, descs, seeds, fx, cx,
                           cy, w: int, h: int, max_distance: float = 5.0,
                           n_hyp: int = 1024):
    """kpts [T,K,3], valids [T,K], descs [T,K,D] keypoint descriptors or
    [T,Hd,Wd,D] dense maps, RANSAC seeds [T] (every rank passes the whole
    sequence, on the mesh's device; T divisible by the data ranks) ->
    (R [T,3,3], t [T,3], ok [T]): the relative pose of pair (max(0, i-1),
    i) for every frame i, on every rank."""
    sl = block(mesh, len(kpts))
    k, v, d = kpts[sl], valids[sl], descs[sl]
    halo = [mesh.ring_shift(x[-1:], "data") for x in (k, v, d)]
    if mesh.data_rank == 0:
        halo = [x[:1] for x in (k, v, d)]
    prev = [torch.cat([a, x[:-1]]) for a, x in zip(halo, (k, v, d))]
    m0, m1, ok = match_block(prev[0], prev[1], k, v, prev[2], d,
                             max_distance, sparse=d.dim() == 3)
    scale = torch.tensor([w - 1.0, h - 1.0], device=ok.device)
    R, t, _, okp = vo_pair_pose(m0[..., 0:2] * scale, m1[..., 0:2] * scale,
                                ok, fx, cx, cy, None, n_hyp,
                                samples=pair_samples(ok, seeds[sl], n_hyp, 8))
    return gather_pairs(mesh, (R, t, okp))
