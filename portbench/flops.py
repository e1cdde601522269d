"""Floating-point operations of a unit of work, counted on the plain
reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products (two operations a multiply-add) of the reference's
mathematics, run on meta tensors: no memory, no device, nothing computed.
Pooling, norms and elementwise work are not counted, and a training step
counts its forward and backward once each, with no recomputation: this is
the work the model needs, whatever the program does to get it.

Nothing here names a model: each traffic entry (``portbench/entries/``)
hands :func:`count` the call of the configuration's reference module that
its check makes, on the meta tensors made here.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

META = torch.device("meta")


def meta_params(spec: list, grad: bool = False) -> dict:
    """Meta tensors of a reference's ``param_spec``."""
    return {n: torch.empty(s, device=META, requires_grad=grad)
            for n, s, _ in spec}


def meta_like(t: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """A meta tensor of ``t``'s shape."""
    return torch.empty(tuple(t.shape), device=META, dtype=dtype)


def count(fn) -> int:
    """The convolution and matrix-product operations of ``fn()``."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
