"""A two-stage GPipe-style pipeline for the extract path (counterpart of
keypoint_bench_tpu/parallel/pipeline.py).

Stage 0 runs the model forward, stage 1 runs detection, and each
microbatch's activations go from stage 0 to stage 1 by the one-way hop
`Mesh.ppermute(..., [(0, 1)])` over a `make_stage_mesh` 'stage' axis.
With M microbatches the pipeline takes M + 1 ticks: at tick i stage 0
runs the forward of microbatch i while stage 1 detects on microbatch
i - 1, and the last tick only drains. Stage 1 writes the outputs, and an
all_reduce (JAX's psum; bools as int32) replicates them to both ranks.

For keypoint evaluation every image and pair is independent, so data
parallelism (parallel/evaluate.py) does strictly better: it pays neither
the bubble (1 / (M + 1) with balanced stages, more otherwise) nor the
hop between the stages. This module makes that comparison measurable; no
runner path uses it.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from keypoint_bench_tpu_torch.ops.detect import DetectParams, detection_batch
from keypoint_bench_tpu_torch.parallel.mesh import Mesh, make_stage_mesh

__all__ = ["make_stage_mesh", "two_stage_pipeline", "pipeline_extract"]

_AXIS = "stage"


def _spec(tree) -> dict:
    """What a rank that did not compute `tree` needs to hold one like it:
    its structure and each leaf's shape and dtype."""
    leaves, spec = pytree.tree_flatten(tree)
    return {"spec": pytree.treespec_dumps(spec),
            "leaves": [[list(x.shape), str(x.dtype)[len("torch."):]]
                       for x in leaves]}


def _zeros(spec: dict, device):
    """A tree of zeros as `_spec` describes it."""
    leaves = [torch.zeros(shape, dtype=getattr(torch, dtype),
                          device=device) for shape, dtype in spec["leaves"]]
    return pytree.tree_unflatten(leaves,
                                 pytree.treespec_loads(spec["spec"]))


def two_stage_pipeline(mesh: Mesh, stage0, stage1, xs):
    """`stage1(stage0(x))` for every microbatch x of `xs` on the two ranks
    of a `make_stage_mesh` mesh; both ranks call it with the same xs.

    xs: a tree (tensors, tuples, lists, dicts) of [M, ...] tensors, M
        microbatches.
    stage0: x -> activation tree (the model forward; runs on stage 0).
    stage1: activation tree -> output tree (detection; runs on stage 1).
    Returns the stacked outputs, a tree of [M, ...] tensors on both ranks,
    bit-equal to the sequential map over the microbatches.
    """
    sid = mesh.groups[_AXIS].rank()
    leaves, _ = pytree.tree_flatten(xs)
    m, dev = leaves[0].shape[0], leaves[0].device
    buf, outs, act_spec = None, None, None
    for i in range(m + 1):
        act = None
        if sid == 0 and i < m:
            act = stage0(pytree.tree_map(lambda a: a[i], xs))
        if sid == 1 and i >= 1:
            out = stage1(buf)
            if outs is None:
                outs = pytree.tree_map(
                    lambda o: torch.zeros((m,) + o.shape, dtype=o.dtype,
                                          device=o.device), out)
            pytree.tree_map(lambda o, v: o.__setitem__(i - 1, v), outs, out)
        if i == m:
            break                     # the drain tick sends nothing on
        if act_spec is None:          # stage 1 learns the activations' shape
            act_spec = mesh.broadcast_json(
                _spec(act) if sid == 0 else None, 0, _AXIS)
        # activations flow 0 -> 1; stage 0 receives zeros
        send = act if sid == 0 else _zeros(act_spec, dev)
        buf = pytree.tree_map(
            lambda a: mesh.ppermute(a, [(0, 1)], _AXIS, "pipeline_hop"),
            send)
    # the outputs live on stage 1; stage 0 holds zeros, and the sum
    # replicates them (bools as int32)
    out_spec = mesh.broadcast_json(_spec(outs) if sid == 1 else None, 1,
                                   _AXIS)
    if sid == 0:
        outs = _zeros(out_spec, dev)

    def rep(o):
        if o.dtype == torch.bool:
            return mesh.all_reduce(o.to(torch.int32), _AXIS) > 0
        return mesh.all_reduce(o, _AXIS)
    return pytree.tree_map(rep, outs)


@torch.inference_mode()
def pipeline_extract(mesh: Mesh, model, dp: DetectParams, imgs,
                     n_micro: int):
    """The extract pipeline: stage 0 the model forward (the weights live
    with stage 0), stage 1 fixed-K detection (`detection_batch`, kernel A
    on the card). imgs [B, H, W, C] with n_micro dividing B -> (kpts
    [B, K, 3], valid [B, K]) on both ranks."""
    b = imgs.shape[0]
    if b % n_micro:
        raise ValueError(f"{n_micro} microbatches do not divide {b} images")
    xs = imgs.reshape((n_micro, b // n_micro) + tuple(imgs.shape[1:]))

    def stage0(x):
        score, _ = model(x)
        return score[..., 0] if score.dim() == 4 else score

    def stage1(score):
        return detection_batch(score, dp)

    kpts, valid = two_stage_pipeline(mesh, stage0, stage1, xs)
    return (kpts.reshape((b,) + tuple(kpts.shape[2:])),
            valid.reshape((b,) + tuple(valid.shape[2:])))
