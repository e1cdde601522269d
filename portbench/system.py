"""The system under test, built from a configuration file: the port's
config, its scene object, its model with the harness's seeded weights, and
a served classifier loaded through the port's artifact format.

A configuration file (``portbench/configs/<config>.json``) holds:
``model_name`` (the port's registry name) and ``reference`` (the plain
reference module, ``portbench/reference/<reference>.py``); the widths,
``model_width``, ``gmfnet_pan`` (optional) and ``trans`` (optional: a
transformer's widths in the port's own key names, ``window_size``,
``embed_dim``, ``depths``, ``num_heads``, and for vit ``patch_size``,
``depth``, ``num_head``; keys it leaves out keep the port's defaults);
``patch_size``, ``city``, ``scene_size``, ``classes``; the precision,
``scene_dtype``, ``compute_dtype``, ``param_dtype``; the schedule,
``activate``, ``optimizer``, ``lr``, ``batchsize``, ``dense_remat``
(optional); and ``source``, ``reduced``, ``assumed``, ``deployment``,
which say where it comes from.

This module and ``portbench/entries/`` are the only places that import the
program (``dmfusion_torch``); they take its entry points, never its
internals' results, into the check.
"""

from __future__ import annotations

import importlib
import os
import tempfile
from typing import Any, Mapping

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reference(config: Mapping[str, Any]):
    """The configuration's plain reference module."""
    return importlib.import_module(
        f"portbench.reference.{config['reference']}")


def tap(config: Mapping[str, Any]):
    """Where the configuration's map logits are read
    (``portbench/taps/<reference>.py``)."""
    return importlib.import_module(f"portbench.taps.{config['reference']}")


def param_spec(config: Mapping[str, Any]) -> list:
    """The configuration's parameters, ``[(name, shape, kind)]``, as its
    reference lists them from the configuration."""
    return reference(config).param_spec(config)


#: The ``trans`` keys the port's transformers read.
TRANS_KEYS = frozenset({"window_size", "embed_dim", "depths", "num_heads",
                        "patch_size", "depth", "num_head"})


def port_config(config: Mapping[str, Any], device: torch.device) -> dict:
    """The port's rendered config for this configuration."""
    from dmfusion_torch.config import load_config

    overrides = {
        "model_name": config["model_name"],
        "model_width": int(config["model_width"]),
        "gmfnet_pan": config.get("gmfnet_pan", "s2d"),
        "patch_size": int(config["patch_size"]),
        "data_city": config["city"],
        "batchsize": int(config["batchsize"]),
        "seed": 0,
        "nohup": True,
        "device": "cpu" if device.type == "cpu" else "cuda",
        "precision": {"compute_dtype": config["compute_dtype"],
                      "param_dtype": config["param_dtype"],
                      "scene_dtype": config["scene_dtype"]},
        "schedule": {"activate": config["activate"],
                     "optimizer": config["optimizer"],
                     "lr": float(config["lr"]), "if_scheduler": 0},
        "train": {"dense_remat": config.get("dense_remat", "auto")},
    }
    if "trans" in config:
        unknown = sorted(set(config["trans"]) - TRANS_KEYS)
        if unknown:
            raise ValueError(f"configuration {config.get('name')}: trans keys "
                             f"{unknown} are none of the port's "
                             f"{sorted(TRANS_KEYS)}")
        overrides["trans"] = dict(config["trans"])
    cfg = load_config(overrides=overrides)
    size = list(cfg["DATA_DICT"][config["city"]]["size"])
    if size != list(config["scene_size"]) or int(
            cfg["Categories_Number"]) != int(config["classes"]):
        raise ValueError(
            f"configuration {config['name']}: city {config['city']} is "
            f"{size} with {cfg['Categories_Number']} classes in the port, "
            f"the file says {config['scene_size']} and {config['classes']}")
    return cfg


def port_scene(scene):
    """The port's ``Scene`` over the harness's tensors (the label map on
    the host, as the port keeps it)."""
    from dmfusion_torch.data.scene import Scene

    return Scene(ms=scene.ms, pan=scene.pan, label=scene.label.cpu().numpy(),
                 height=scene.height, width=scene.width, patch=scene.patch)


def model_with(cfg: Mapping[str, Any], weights: Mapping[str, torch.Tensor],
               device: torch.device) -> torch.nn.Module:
    """The port's model for ``cfg`` on ``device`` (channels-last memory on
    the card, as the port's solver places it) holding ``weights``."""
    from dmfusion_torch.models import build_model

    model = build_model(cfg)
    if device.type == "cuda":
        model = model.to(device, memory_format=torch.channels_last)
    model.load_state_dict(dict(weights), strict=True)
    return model


def served_classifier(cfg: Mapping[str, Any],
                      weights: Mapping[str, torch.Tensor],
                      device: torch.device):
    """The classifier a user serves: the model packaged by the port's
    ``save_artifact`` and read back by ``load_artifact`` onto ``device``
    (the artifact is a temporary file, removed once read)."""
    from dmfusion_torch.export import load_artifact, save_artifact

    model = model_with(cfg, weights, torch.device("cpu"))
    fd, path = tempfile.mkstemp(suffix=".zip", prefix="portbench-artifact-")
    os.close(fd)
    try:
        save_artifact(path, cfg, model)
        return load_artifact(path, device)
    finally:
        os.remove(path)
