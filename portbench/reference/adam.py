"""Plain Adam, as written in Kingma and Ba (2015), over a dict of tensors.

``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, and ``p -= lr *
(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``, in float32.
"""

from __future__ import annotations

from typing import Mapping

import torch


class Adam:
    def __init__(self, params: Mapping[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.sub_(self.lr * (self.m[k] / c1) / denom)
