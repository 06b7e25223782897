"""String-keyed model registry (mirrors keypoint_bench_tpu/models/registry.py)."""
from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_model(name: str):
    """The model class registered under `name`; build it with its params."""
    if name not in _REGISTRY:
        import keypoint_bench_tpu_torch.models.alike  # noqa: F401 (registers)
        import keypoint_bench_tpu_torch.models.superpoint  # noqa: F401
        import keypoint_bench_tpu_torch.models.xfeat  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)} "
                       f"(other models are still to port, see ROADMAP.md)")
    return _REGISTRY[name]
