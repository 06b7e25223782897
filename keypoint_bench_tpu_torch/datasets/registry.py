"""Dataset factory keyed on params['type'] (counterpart of
keypoint_bench_tpu/datasets/registry.py). Ported: the synthetic homography
and SE3 pairs, both synthetic sequences and the in-process `preloaded` type. The
file-backed loaders are not (ROADMAP.md, Queue 1)."""
from __future__ import annotations

# in-process pre-materialized datasets (benchmarks and tests make the
# batches once and time only the pipeline): register_preloaded(name, items),
# then data_params = {"type": "preloaded", "name": name}
_PRELOADED: dict[str, list] = {}


def register_preloaded(name: str, items: list):
    _PRELOADED[name] = list(items)


def get_dataset(params: dict):
    t = params["type"]
    if t == "preloaded":
        return _PRELOADED[params["name"]]
    if t == "synthetic_homography":
        from keypoint_bench_tpu_torch.datasets.synthetic import \
            SyntheticHomographyDataset
        return SyntheticHomographyDataset(params.get("num_pairs", 8),
                                          params.get("image_size", 512),
                                          params.get("seed", 0))
    if t == "synthetic_se3":
        from keypoint_bench_tpu_torch.datasets.synthetic import \
            SyntheticSE3Dataset
        return SyntheticSE3Dataset(params.get("num_pairs", 4),
                                   params.get("image_size", 256),
                                   params.get("seed", 0))
    if t == "synthetic_splat_sequence":
        from keypoint_bench_tpu_torch.datasets.synthetic import \
            SyntheticSplatSequenceDataset
        return SyntheticSplatSequenceDataset(params.get("num_frames", 6),
                                             params.get("image_size", 256),
                                             params.get("seed", 0))
    if t == "synthetic_sequence":
        from keypoint_bench_tpu_torch.datasets.synthetic import \
            SyntheticSequenceDataset
        return SyntheticSequenceDataset(params.get("num_frames", 10),
                                        params.get("image_size", 256),
                                        params.get("seed", 0))
    raise NotImplementedError(
        f"dataset type {t!r} is not ported yet (ROADMAP.md, Queue 1)")
