"""String-keyed model registry (mirrors keypoint_bench_tpu/models/registry.py)."""
from __future__ import annotations

import importlib

_REGISTRY: dict[str, type] = {}
# models configured by `model_params` instead of weights
PARAM_MODELS = ("Harris", "ORB", "SIFT")
_MODULES = ("alike", "letnet", "goodpoint", "superpoint", "xfeat",
            "edgepoint", "keynet", "harris", "disk", "r2d2", "sfd2", "d2net",
            "orb", "sift")


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_model(name: str):
    """The model class registered under `name`; build it with its params
    (the torch-layout weights, or `model_params` for Harris, ORB and
    SIFT)."""
    if name not in _REGISTRY:
        # import the model modules lazily, so that one broken model does
        # not take the registry down
        for mod in _MODULES:
            full = f"keypoint_bench_tpu_torch.models.{mod}"
            try:
                importlib.import_module(full)
            except ModuleNotFoundError as e:
                if e.name != full:   # a real dependency failure inside
                    raise
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models() -> list[str]:
    """The registered model names, sorted, after the lazy imports."""
    try:
        get_model("__none__")   # forces the lazy imports
    except KeyError:
        pass
    return sorted(_REGISTRY)
