"""Config loading, ``{{...}}`` self-interpolation, run slots and device
resolution.

A copy of ``dmfusion/config/__init__.py``: the same placeholder
vocabulary, the same two interpolation passes and the same validation, so
one YAML file or override dict renders to the same dict in both packages;
and the same run-slot allocation (:func:`prepare_run`), so both packages
pick the same ``FILE_NUM`` slot in one result tree.  ``yaml`` is imported
only when a file is read: without PyYAML, a run goes through the built-in
schema and ``--set`` overrides.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Iterable, Mapping

import torch

from dmfusion_torch.config.schema import (DATA_DICT, DEFAULTS,  # noqa: F401
                                          _deep_merge, validate)

_PLACEHOLDER = re.compile(r"\{\{\s*(\w+)\s*\}\}")


def _interp_params(cfg: Mapping[str, Any]) -> dict[str, Any]:
    """The placeholder vocabulary the reference exposes (utils/config.py:21-36)."""
    city = cfg["data_city"]
    if city not in cfg["DATA_DICT"]:
        raise ValueError(f"unknown data_city {city!r}; known: "
                         f"{sorted(cfg['DATA_DICT'])}")
    return {
        "p2": str(Path(__file__).resolve().parents[2]),
        "dc": city,
        "num": len(cfg["DATA_DICT"][city]["color"]),
        "tr": cfg["train_rate"],
        "ep": cfg["epoch"],
        "bs": cfg["batchsize"],
        "mn": cfg["model_name"],
        "FN": cfg["FILE_NUM"],
        "ne": cfg["dqtl"]["num_epochs"],
        "ps": cfg["dqtl"]["pic_size"],
        "expo_result": cfg.get("expo_result", ""),
        "parameters": cfg.get("parameters", ""),
        "RESULT": cfg.get("RESULT", ""),
    }


def _interpolate(node: Any, params: Mapping[str, Any]) -> Any:
    if isinstance(node, str):
        def sub(m: re.Match) -> str:
            name = m.group(1)
            return str(params[name]) if name in params else m.group(0)
        return _PLACEHOLDER.sub(sub, node)
    if isinstance(node, dict):
        return {k: _interpolate(v, params) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, params) for v in node]
    return node


def render_config(cfg: Mapping[str, Any]) -> dict[str, Any]:
    """Resolve ``{{...}}`` placeholders in all string values, then validate
    (two passes, so templates that reference templated values resolve)."""
    out = _deep_merge(DEFAULTS, dict(cfg))
    for _ in range(2):
        out = _interpolate(out, _interp_params(out))
    return validate(out)


def load_config(path: str | os.PathLike | None = None,
                overrides: Mapping[str, Any] | None = None,
                prepare: bool = False) -> dict[str, Any]:
    """Load a YAML config file (or pure defaults), apply overrides, render,
    optionally allocate a run slot."""
    raw: dict[str, Any] = {}
    if path is not None:
        import yaml
        with open(path, encoding="utf-8") as f:
            raw = yaml.safe_load(f) or {}
    if overrides:
        raw = _deep_merge(raw, dict(overrides)) if raw else dict(overrides)
    cfg = render_config(raw)
    if prepare:
        cfg = prepare_run(cfg)
    return cfg


def prepare_run(cfg: dict[str, Any]) -> dict[str, Any]:
    """Allocate result paths with an auto-incrementing run number.

    As ``dmfusion.config.prepare_run`` (reference ``get_dump_config``):
      * ensure the RESULT directory exists,
      * when training, advance FILE_NUM past every occupied slot,
      * with ``train.resume`` set, reuse the newest unfinished slot (its
        output dir exists but its result workbook was never written), so
        a resumed run finds its ``curweights``,
      * else with ``delete`` set, remove orphan ``_output`` dirs lacking a
        result workbook and reuse the lowest freed slot,
      * finally create the output dir.
    """
    cfg = dict(cfg)
    result_dir = cfg.get("RESULT") or os.path.join(
        cfg["expo_result"],
        f"{cfg['data_city']}_tr{cfg['train_rate']}_ep{cfg['epoch']}_bs{cfg['batchsize']}",
    )
    if not result_dir.endswith(os.sep) and not result_dir.endswith("/"):
        result_dir += "/"
    os.makedirs(result_dir, exist_ok=True)

    def slot_paths(num: int) -> tuple[str, str]:
        stem = f"{cfg['model_name']}__{num}"
        return (os.path.join(result_dir, stem + "_result.xlsx"),
                os.path.join(result_dir, stem + "_output/"))

    filenum = 0
    if cfg["train"]["index"]:
        excel, outdir = slot_paths(filenum)
        while os.path.exists(excel) or os.path.exists(outdir):
            filenum += 1
            excel, outdir = slot_paths(filenum)
        if cfg["train"].get("resume"):
            for num in range(filenum - 1, -1, -1):
                ex, od = slot_paths(num)
                if os.path.isdir(od) and not os.path.isfile(ex):
                    filenum = num
                    break
        elif cfg.get("delete"):
            for num in range(filenum - 1, -1, -1):
                ex, od = slot_paths(num)
                if os.path.isdir(od) and not os.path.isfile(ex):
                    shutil.rmtree(od)
                    filenum = num
    else:
        filenum = int(cfg.get("FILE_NUM", 0))

    excel, outdir = slot_paths(filenum)
    cfg["FILE_NUM"] = filenum
    cfg["RESULT"] = result_dir
    cfg["RESULT_excel"] = excel
    cfg["RESULT_output"] = outdir
    if cfg["train"].get("save_best", True):
        os.makedirs(outdir, exist_ok=True)
    return cfg


def _parse_value(text: str) -> Any:
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def _nest(flat: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def parse_overrides(items: Iterable[str]) -> dict[str, Any]:
    """``["schedule.lr=1e-4", "device=cpu"]`` -> nested override dict
    (the ``--set`` surface of ``dmfusion/cli.py``)."""
    flat: dict[str, Any] = {}
    for item in items:
        key, _, value = item.partition("=")
        flat[key] = _parse_value(value)
    return _nest(flat)


def resolve_device(cfg: Mapping[str, Any]) -> torch.device:
    """``device: cpu`` is the CPU; every other value (``tpu``, ``cuda``,
    ``gpu``, empty) is ``cuda:0``.  Raises when that card is absent, so a
    run never drops to the CPU unasked."""
    if str(cfg.get("device", "")).lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={cfg.get('device')!r} resolves to cuda:0 but no CUDA "
            "device is available; pass --set device=cpu to run on the CPU")
    return torch.device("cuda", 0)
