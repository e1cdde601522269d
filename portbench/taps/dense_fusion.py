"""dense_fusion's map logits: ``logits_s2d``, which ``class_map`` calls
for an even patch and argmaxes per phase block, returns the (ni, nj,
4 classes) float32 logits in phase-major blocks (channels ``[row-phase,
col-phase, class]``), the s2d-2 packing of the (2 ni, 2 nj, classes)
map."""

from __future__ import annotations

import torch

from portbench.reference.common import depth_to_space

METHOD = "logits_s2d"


def logits_map(out: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return depth_to_space(out.float(), 2)[:height, :width]
