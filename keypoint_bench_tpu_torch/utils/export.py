"""Model export (counterpart of keypoint_bench_tpu/utils/export.py, which
serializes a jitted forward's StableHLO).

`torch.export` traces a model's forward at a fixed input shape into an
ExportedProgram, which `torch.export.save` writes to a `.pt2` file and any
later process loads and calls without the model's Python code. The
program keeps the device it was traced on.
"""
from __future__ import annotations

import os

import torch

from keypoint_bench_tpu_torch.device import resolve_device


def export_model(model_name: str, out_path: str,
                 input_shape=(1, 512, 512, 3), weights_dir: str | None = None,
                 device: str | torch.device = "cuda") -> str:
    """Trace the forward of `model_name` on a float32 image of
    `input_shape` ([B, H, W, C]) on `device` and write it to `out_path`
    (.pt2). Returns the path."""
    from keypoint_bench_tpu_torch.models import get_model
    from keypoint_bench_tpu_torch.weights import load_params

    dev = resolve_device(device)
    model = get_model(model_name)(
        load_params(model_name, weights_dir, dev)).eval()
    example = torch.zeros(tuple(input_shape), dtype=torch.float32,
                          device=dev)
    with torch.no_grad():
        program = torch.export.export(model, (example,))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    return out_path


def load_exported(path: str):
    """Load an exported model; returns a callable(image) -> its forward's
    outputs. A program traced on the card calls the operator
    `kbt::bn_epilogue`, which importing ops/cuda_bn.py defines."""
    from keypoint_bench_tpu_torch.ops import cuda_bn  # noqa: F401

    module = torch.export.load(path).module()

    def call(image: torch.Tensor):
        with torch.no_grad():
            return module(image)
    return call
