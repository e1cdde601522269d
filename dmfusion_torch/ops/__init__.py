"""Device ops of the port: the window-gather and phase window-pool
kernels (each beside its plain version) and metrics."""

from __future__ import annotations

import torch


def records_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd would record an op on ``tensors``: grad enabled and
    one of them requiring it.  The hand-written kernels have no backward,
    so they run only where this is false."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
