"""Weight layouts and the one-time torch checkpoint -> npz converter (the
port's copy of keypoint_bench_tpu/weights/convert.py, without JAX).

    python -m keypoint_bench_tpu_torch.weights.convert --src DIR [--dst DIR]

converts the reference's own checkpoints (SPECS: the upstream file names
and their nesting) under --src into `<dst>/<model>.npz`, the files both
packages load. --src names the directory of the user's checkpoints and is
required; --dst defaults to WEIGHTS_DIR (`$KBT_WEIGHTS_DIR`, else
weights_npz/).
Layout transforms applied per tensor rank, whatever the tensor's name:
  4D conv [O, I, kh, kw]      -> HWIO [kh, kw, I, O]
  2D linear [out, in]         -> [in, out]
  any other rank              -> unchanged
Only floating tensors are kept (`num_batches_tracked` and other integer
buffers are dropped). Files that are missing, or under 1024 bytes (git LFS
pointers), are skipped.

`params_from_jax` is the way back: the JAX-layout arrays of such a file as
torch-layout tensors. bf16 arrays (the JAX package's `cast_params_bf16`
output, whose numpy dtype is ml_dtypes' "bfloat16") stay bf16; everything
else becomes float32.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def to_torch_layout(a: np.ndarray) -> np.ndarray:
    """The inverse of `to_numpy_layout`'s rank rule: HWIO -> OIHW,
    [in, out] -> [out, in], other ranks as they are (a view)."""
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return a.T
    return a


def _tensor(v, device) -> torch.Tensor:
    a = np.asarray(v)
    # numpy has no bf16 of its own: go through f32, which holds it exactly
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    t = torch.from_numpy(np.ascontiguousarray(
        to_torch_layout(a.astype(np.float32))))
    return t.to(device, dtype)


def params_from_jax(np_params: dict,
                    device: str | torch.device = "cpu") -> dict:
    """{name: array in JAX layout} -> {name: tensor in torch layout} on
    `device`: float32, or bf16 for a bf16 array."""
    return {k: _tensor(v, device) for k, v in np_params.items()}


def to_numpy_layout(key: str, t: torch.Tensor) -> np.ndarray:
    """A torch checkpoint tensor as a numpy array in the JAX layout (the
    rule goes by rank; `key` is not looked at)."""
    a = t.detach().cpu().numpy()
    if a.ndim == 4:
        return np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
    if a.ndim == 2:
        return np.transpose(a, (1, 0))
    return a


def convert_state_dict(sd: dict) -> dict:
    """The floating tensors of a state dict in the JAX layout."""
    return {k: to_numpy_layout(k, v) for k, v in sd.items()
            if torch.is_tensor(v) and v.dtype.is_floating_point}


def _strip_module(c):
    return {k.replace("module.", ""): v for k, v in c["state_dict"].items()}


# model name -> (weight file under --src, unwrap of the loaded checkpoint),
# as the reference's loaders nest them (models/model_interface.py:43-85)
SPECS = {
    "Alike": ("alike-t.pth", lambda c: c),
    "EdgePoint": ("EdgePoint.pt", lambda c: c),
    "GoodPoint": ("goodpoint.pth", lambda c: c),
    "LETNet": ("letnet.pth", lambda c: c),
    "KeyNet": ("keynet_pytorch.pth", lambda c: c["state_dict"]),
    "r2d2": ("r2d2_WASF_N16.pt", _strip_module),
    # large blobs, present only if the user supplies them:
    "SuperPoint": ("weights/superpoint_v1.pth", lambda c: c),
    "XFeat": ("weights/xfeat.pt", lambda c: c),
    "DISK": ("weights/disk.pth", lambda c: c["extractor"]),
    "sfd2": ("weights/sfd2.pth", lambda c: c["model"]),
    "D2Net": ("weights/d2_tf.pth", lambda c: c.get("model", c)),
    "lightglue_superpoint": ("weights/superpoint_lightglue.pth", lambda c: c),
    "lightglue_disk": ("weights/disk_lightglue.pth", lambda c: c),
    "lightglue_aliked": ("weights/aliked_lightglue.pth", lambda c: c),
}


def main(src: str, dst: str):
    """Convert every SPECS checkpoint found under `src` into `dst`; prints
    the converted models with their tensor counts, then the skipped ones.
    Returns (converted [(name, tensors)], skipped [name])."""
    from keypoint_bench_tpu_torch.weights.io import save_params

    converted, skipped = [], []
    for name, (fname, unwrap) in SPECS.items():
        path = os.path.join(src, fname)
        if not os.path.exists(path) or os.path.getsize(path) < 1024:
            skipped.append(name)
            continue
        # the user's own checkpoints: the upstream r2d2 / KeyNet pickles
        # hold more than tensors
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        params = convert_state_dict(unwrap(ckpt))
        save_params(name, params, dst)
        converted.append((name, len(params)))
    for name, n in converted:
        print(f"converted {name}: {n} tensors")
    if skipped:
        print(f"skipped (missing blobs): {', '.join(skipped)}")
    return converted, skipped


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="keypoint_bench_tpu_torch.weights."
                                      "convert")
    from keypoint_bench_tpu_torch.weights.io import WEIGHTS_DIR
    ap.add_argument("--src", required=True,
                    help="the directory of the reference's checkpoints")
    ap.add_argument("--dst", default=None)
    args = ap.parse_args()
    main(args.src, args.dst or WEIGHTS_DIR)
