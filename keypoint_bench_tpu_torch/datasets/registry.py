"""Dataset factory keyed on params['type'] (counterpart of
keypoint_bench_tpu/datasets/registry.py): every type it builds, with the
same parameter names and defaults. File-backed: hpatches, megadepth,
image_pair (datasets/pairs.py), kitti, tartanair, euroc, uma, video,
images (datasets/sequences.py); synthetic: the homography and SE3 pairs
and both sequences (datasets/synthetic.py); and the in-process
`preloaded` type. An unknown type raises ValueError."""
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
    if t == "hpatches":
        from keypoint_bench_tpu_torch.datasets.pairs import HPatchesDataset
        return HPatchesDataset(params["root"], params.get("alteration", "all"),
                               params.get("image_size", 512),
                               params.get("gray", False))
    if t == "megadepth":
        from keypoint_bench_tpu_torch.datasets.pairs import MegaDepthDataset
        return MegaDepthDataset(params["root"],
                                params.get("image_size", 512),
                                params.get("gray", False),
                                params.get("train", False),
                                params.get("crop_or_scale", "scale"))
    if t == "image_pair":
        from keypoint_bench_tpu_torch.datasets.pairs import ImagePairsDataset
        resize = ([params["image_size"]] * 2
                  if "image_size" in params else None)
        return ImagePairsDataset(params["root"], params.get("gray", False),
                                 resize)
    if t == "kitti":
        from keypoint_bench_tpu_torch.datasets.sequences import KittiDataset
        return KittiDataset(params["root"], params["gt"],
                            params.get("gray", False))
    if t == "tartanair":
        from keypoint_bench_tpu_torch.datasets.sequences import \
            TartanAirDataset
        return TartanAirDataset(params["root"], params["gt"],
                                params.get("gray", False))
    if t == "euroc":
        from keypoint_bench_tpu_torch.datasets.sequences import EurocDataset
        return EurocDataset(params["root"], params.get("gray", False))
    if t == "uma":
        from keypoint_bench_tpu_torch.datasets.sequences import UMADataset
        return UMADataset(params["root"], params.get("gray", False))
    if t == "video":
        from keypoint_bench_tpu_torch.datasets.sequences import VideoDataset
        return VideoDataset(params["root"], params.get("gray", False))
    if t == "images":
        from keypoint_bench_tpu_torch.datasets.sequences import ImagesDataset
        return ImagesDataset(params["root"], params.get("gray", False))
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
    raise ValueError(f"invalid dataset type {t!r}")
