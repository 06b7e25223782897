"""Weight loading: the JAX package's converted `.npz` files, read with numpy.

`weights_npz/<name>.npz` (or `$KBT_WEIGHTS_DIR/<name>.npz`) holds the torch
parameter names with conv kernels in HWIO and linears in [in, out] (the
JAX layout); `params_from_jax` (weights/convert.py) turns them back into
torch's OIHW / [out, in], and `save_params` writes such a file (the
converter's output).

`tests/golden/<name>.npz` fixtures hold the same layout under `param:`
keys: full-width parameters with randomized values for the models whose
upstream checkpoints are not in the repository (SuperPoint, XFeat,
LightGlue, D2Net, DISK, sfd2). `load_golden_params` reads them;
`stage_golden_weights` writes them into a `weights_dir` under the names
the runner loads;
`lightglue_input_proj_params` adds the 64 -> 256 input projection that the
AUC step's XFeat descriptors need.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from keypoint_bench_tpu_torch.weights.convert import params_from_jax

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# KBT_WEIGHTS_DIR points at converted weights outside the checkout, as in
# the JAX package
WEIGHTS_DIR = os.environ.get("KBT_WEIGHTS_DIR",
                             os.path.join(REPO_DIR, "weights_npz"))
GOLDEN_DIR = os.path.join(REPO_DIR, "tests", "golden")

# the *_s2d models are TPU layout variants of the same checkpoint and
# forward (the JAX package transforms the weights; the port needs not)
_ALIASES = {"Alike_s2d": "Alike", "LETNet_s2d": "LETNet",
            "GoodPoint_s2d": "GoodPoint"}
# golden fixture -> the weights_dir file name the runner loads
GOLDEN_STAGE_NAMES = {"SuperPoint": "SuperPoint", "XFeat": "XFeat",
                      "lightglue": "lightglue_superpoint", "D2Net": "D2Net",
                      "DISK": "DISK", "sfd2": "sfd2"}
_PREFIX = "param:"


def load_npz(name: str, weights_dir: str | None = None) -> dict:
    """The JAX-layout numpy parameters of model `name`."""
    name = _ALIASES.get(name, name)
    path = os.path.join(weights_dir or WEIGHTS_DIR, f"{name}.npz")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_params(name: str, params: dict, weights_dir: str | None = None):
    """Write `params` ({name: array in the JAX layout}; CPU tensors are
    taken as they are) to <weights_dir>/<name>.npz with `np.savez`, as the
    JAX package's `save_params` writes it, so that both packages read the
    file."""
    d = weights_dir or WEIGHTS_DIR
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, f"{name}.npz"),
             **{k: np.asarray(v) for k, v in params.items()})


PRECISIONS = ("float32", "bfloat16")


def check_precision(precision: str) -> str:
    """`precision` if the port runs it; ValueError otherwise."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return precision


def load_params(name: str, weights_dir: str | None = None,
                device: str | torch.device = "cpu",
                precision: str = "float32") -> dict:
    """Torch-layout parameters of model `name`: float32 tensors, or with
    precision="bfloat16" the weights of rank >= 2 in bf16
    (`models.common.cast_params_bf16`)."""
    params = params_from_jax(load_npz(name, weights_dir), device)
    if check_precision(precision) == "bfloat16":
        from keypoint_bench_tpu_torch.models.common import cast_params_bf16
        params = cast_params_bf16(params)
    return params


def golden_npz(name: str) -> dict:
    """The JAX-layout `param:` arrays of tests/golden/<name>.npz, with the
    prefix stripped."""
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as g:
        return {k[len(_PREFIX):]: g[k] for k in g.files
                if k.startswith(_PREFIX)}


def load_golden_params(name: str,
                       device: str | torch.device = "cpu") -> dict:
    """Torch-layout parameters of the golden fixture `name`."""
    return params_from_jax(golden_npz(name), device)


def lightglue_input_proj_params(device: str | torch.device = "cpu") -> dict:
    """Torch-layout golden LightGlue parameters plus the 64 -> dim
    `input_proj` (the disk / aliked schema) that XFeat's descriptors need,
    as bench.py's AUC chain builds it: weight rng(7).normal(0, 0.1, (64,
    dim)) in the JAX [in, out] layout, zero bias."""
    lg = golden_npz("lightglue")
    if "input_proj.weight" not in lg:
        dim = int(lg["transformers.0.self_attn.Wqkv.weight"].shape[0])
        lg["input_proj.weight"] = np.random.default_rng(7).normal(
            0, 0.1, (64, dim)).astype(np.float32)
        lg["input_proj.bias"] = np.zeros((dim,), np.float32)
    return params_from_jax(lg, device)


def stage_golden_weights(weights_dir: str) -> str:
    """Write the golden parameters of GOLDEN_STAGE_NAMES into
    `weights_dir` under the runner's names (`SuperPoint.npz`, `XFeat.npz`,
    `lightglue_superpoint.npz`, `D2Net.npz`, `DISK.npz`, `sfd2.npz`; JAX
    layout, as weights_npz/ holds them); returns `weights_dir`."""
    os.makedirs(weights_dir, exist_ok=True)
    for name, stage in GOLDEN_STAGE_NAMES.items():
        np.savez(os.path.join(weights_dir, f"{stage}.npz"), **golden_npz(name))
    return weights_dir
