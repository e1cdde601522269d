"""Miscellaneous utilities — the port's copy of ``dmfusion/utils/misc.py``.

  * :func:`parse_switch` — one parser for every on/off/auto config knob,
  * :func:`seed_everything` — python, numpy and torch's global generators
    (the port passes explicit generators wherever it draws, so this only
    pins code that does not),
  * :func:`data_show` — the label-raster statistics print of solver
    start-up.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def parse_switch(value, name: str = "switch") -> str:
    """Normalize a tri-state config knob to 'on' / 'off' / 'auto'.

    YAML booleans (``False`` -> ``'false'``), 0/1, yes/no and on/off all
    map consistently; an unknown spelling raises instead of silently
    meaning "on".
    """
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no"):
        return "off"
    if v in ("on", "1", "true", "yes"):
        return "on"
    if v == "auto":
        return "auto"
    raise ValueError(
        f"{name}: unrecognized value {value!r} (use on/off/auto, "
        "1/0, true/false, or yes/no)")


def seed_everything(seed: int = 42) -> None:
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def data_show(label: np.ndarray) -> dict:
    """Print + return class histogram stats for a label raster."""
    values, counts = np.unique(label, return_counts=True)
    stats = {
        "classes": values.tolist(),
        "counts": counts.tolist(),
        "shape": list(label.shape),
        "num_labeled_classes": int(len(values) - (1 if 0 in values else 0)),
    }
    print(f"label classes {stats['classes']} counts {stats['counts']} "
          f"shape {stats['shape']} labeled classes "
          f"{stats['num_labeled_classes']}")
    return stats
