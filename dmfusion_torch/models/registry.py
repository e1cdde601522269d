"""Model registry: ``Net(cfg)`` by config name.

Port of ``dmfusion/models/registry.py``: every model of dmfusion's zoo,
``vit`` as a second name of vision_transformer, and any class a caller
adds with :func:`register`.  An unknown name raises a ``ValueError`` that
lists the known ones.  A model's arity comes from the fixed table below,
else from its module's ``ARITY`` (the registered class's own module), else
"dual", as dmfusion reads it.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Callable, Mapping

_EXPLICIT: dict[str, Callable] = {}

# Ported model name -> module under dmfusion_torch.models.
_PORTED = {"gmfnet": "gmfnet", "gmfnet_conv": "gmfnet_conv",
           "dense_fusion": "dense_fusion", "tri_net": "tri_net",
           "resnet18": "resnet18", "cross_net": "cross_net",
           "vision_transformer": "vit", "vit": "vit", "dqtl": "dqtl",
           "swin_transformer": "swin", "swin_t_dual": "swin_dual",
           "ct_lstm": "ct_lstm", "generator": "generator",
           "discriminator": "discriminator"}

# Model input contract (``dmfusion/models/registry.py``): how windows are
# gathered and fed.  Names absent here take their module's ``ARITY``, else
# "dual": model(ms, pan); "single" is model(ms).
_ARITY = {
    "dense_fusion": "dense",
    "tri_net": "tri",
    "dqtl": "quad",
    "generator": "image",
    "discriminator": "image",
}


def register(name: str) -> Callable:
    def deco(cls):
        _EXPLICIT[name.lower()] = cls
        return cls
    return deco


def get_model_class(name: str):
    key = name.lower()
    if key not in _EXPLICIT:
        if key not in _PORTED:
            raise ValueError(f"unknown model {name!r}; available: "
                             f"{available_models()}")
        importlib.import_module(f"dmfusion_torch.models.{_PORTED[key]}")
    return _EXPLICIT[key]


def build_model(cfg: Mapping[str, Any], name: str | None = None):
    """Instantiate ``Net(cfg)`` for ``cfg['model_name']`` (or ``name``)."""
    return get_model_class(name or cfg["model_name"])(cfg=dict(cfg))


def _model_module(key: str):
    """The module that defines a known model: a registered class's own,
    else the ported module; None for an unknown name."""
    if key in _EXPLICIT:
        name = _EXPLICIT[key].__module__
        return sys.modules.get(name) or importlib.import_module(name)
    if key in _PORTED:
        return importlib.import_module(f"dmfusion_torch.models.{_PORTED[key]}")
    return None


def model_arity(name: str) -> str:
    key = name.lower()
    if key in _ARITY:
        return _ARITY[key]
    return getattr(_model_module(key), "ARITY", "dual")


def model_map_programs(name: str) -> str | None:
    """The map-route programs a model's module declares
    (``MAP_PROGRAMS``): "convmap" renders whole-scene maps through
    ``train/steps.py::ConvMapPrograms`` (gmfnet_conv); None otherwise."""
    return getattr(_model_module(name.lower()), "MAP_PROGRAMS", None)


def available_models() -> list[str]:
    return sorted(set(_EXPLICIT) | set(_PORTED))
