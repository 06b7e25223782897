"""Checkpoints in the reference's own schema, written from the parameters
the repository holds: the inverse of the converter, for the checks of the
converter and of the paths that load converted weights (the CPU tests and
chip_smoke.py's phases 62-63).

`upstream_params` takes weights_npz/ for the shipped models, the golden
randomized fixtures for the rest, and the golden LightGlue with a seeded
128 -> 256 input projection for the disk and aliked schemas;
`write_upstream_checkpoints` writes them under SPECS' file names, in the
upstream layout and nesting; `npz_equal` holds a converted file against
its source bit for bit.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from keypoint_bench_tpu_torch.weights.convert import SPECS, to_torch_layout
from keypoint_bench_tpu_torch.weights.io import golden_npz, load_npz

NPZ_MODELS = ("Alike", "EdgePoint", "GoodPoint", "LETNet", "KeyNet", "r2d2")
GOLDEN_UPSTREAM = {"SuperPoint": "SuperPoint", "XFeat": "XFeat",
                   "DISK": "DISK", "sfd2": "sfd2", "D2Net": "D2Net",
                   "lightglue_superpoint": "lightglue"}
# (seed, std) of the 128 -> 256 input projection; the bias has std 0.1
LG_INPUT_PROJ = {"lightglue_disk": (128, 1.0),
                 "lightglue_aliked": (129, 1.0)}
# the nesting of each upstream file: the inverse of SPECS' unwrap
UPSTREAM_NESTING = {
    "KeyNet": lambda sd: {"state_dict": sd},
    "r2d2": lambda sd: {"state_dict": {f"module.{k}": v
                                       for k, v in sd.items()}},
    "DISK": lambda sd: {"extractor": sd},
    "sfd2": lambda sd: {"model": sd},
    "D2Net": lambda sd: {"model": sd},
}
LFS_POINTER = (b"version https://git-lfs.github.com/spec/v1\n"
               b"oid sha256:" + b"0" * 64 + b"\nsize 1048576\n")


def upstream_params(names=None) -> dict:
    """{SPECS name: JAX-layout numpy params} for `names` (default: every
    SPECS entry; each has parameters in the repository)."""
    out = {}
    for name in names or SPECS:
        if name in NPZ_MODELS:
            out[name] = load_npz(name)
        elif name in GOLDEN_UPSTREAM:
            out[name] = golden_npz(GOLDEN_UPSTREAM[name])
        else:
            seed, std = LG_INPUT_PROJ[name]
            lg = golden_npz("lightglue")
            dim = int(lg["transformers.0.self_attn.Wqkv.weight"].shape[0])
            rng = np.random.default_rng(seed)
            out[name] = {
                "input_proj.weight": rng.normal(
                    0, std, (128, dim)).astype(np.float32),
                "input_proj.bias": rng.normal(0, 0.1, dim).astype(np.float32),
                **lg}
    return out


def write_upstream_checkpoints(src: str, params: dict, pointers=()) -> str:
    """Write each {name: JAX-layout params} of `params` as the reference's
    checkpoint under src (SPECS' file name, the upstream layout and
    nesting, an int64 num_batches_tracked beside every BatchNorm, the r2d2
    `module.` prefix); the names in `pointers` as a git-LFS pointer file
    (under 1024 bytes). Returns src."""
    for name, p in params.items():
        path = os.path.join(src, SPECS[name][0])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if name in pointers:
            with open(path, "wb") as f:
                f.write(LFS_POINTER)
            continue
        sd = {}
        for k, a in p.items():
            sd[k] = torch.from_numpy(np.ascontiguousarray(
                to_torch_layout(a)))
            if k.endswith(".running_var"):
                sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                    torch.tensor(1000, dtype=torch.int64)
        torch.save(UPSTREAM_NESTING.get(name, lambda d: d)(sd), path)
    return src


def npz_equal(path: str, params: dict) -> bool:
    """The npz at path holds exactly `params`' keys, each with the same
    dtype, shape and bits."""
    with np.load(path) as z:
        return sorted(z.files) == sorted(params) and all(
            z[k].dtype == params[k].dtype and z[k].shape == params[k].shape
            and z[k].tobytes() == np.ascontiguousarray(params[k]).tobytes()
            for k in params)
