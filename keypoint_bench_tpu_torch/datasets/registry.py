"""Dataset factory keyed on params['type'] (counterpart of
keypoint_bench_tpu/datasets/registry.py). Only the synthetic homography
pairs are ported so far."""
from __future__ import annotations


def get_dataset(params: dict):
    t = params["type"]
    if t == "synthetic_homography":
        from keypoint_bench_tpu_torch.datasets.synthetic import \
            SyntheticHomographyDataset
        return SyntheticHomographyDataset(params.get("num_pairs", 8),
                                          params.get("image_size", 512),
                                          params.get("seed", 0))
    raise NotImplementedError(
        f"dataset type {t!r} is not ported yet (ROADMAP.md, Queue 1)")
