"""Plain PyTorch operations the references are written in.

Every operation runs in float32 on the caller's device.  ``q`` is the
rounding applied to the two operands of every convolution and matrix
product: :func:`exact` (none) for the reference itself, :func:`fp8` for
the control, which computes the same mathematics with operands rounded to
float8 (e4m3) as a lower-precision program would, and :func:`bf16`, the
configurations' compute dtype, which sets the scale of a training
gradient's rounding gap (``portbench/checks.py``).  The caller turns
TF32 off (:func:`strict_float32`), so float32 stays float32 on the card.

This file imports torch alone: nothing of the program under test, and
neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

Round = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude mapped to 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Rounds the operand in the forward and its gradient in the backward,
    as a step computed in float8 rounds both."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad)


class _Bf16(torch.autograd.Function):
    """Rounds the operand to bfloat16 in the forward and its gradient in
    the backward."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` in bfloat16; under autograd its gradient too."""
    return _Bf16.apply(x)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float8 e4m3 (one scale a tensor); under autograd its
    gradient is rounded the same way."""
    return _Fp8.apply(x)


@contextlib.contextmanager
def strict_float32():
    """No TF32 in float32 products and convolutions while open."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding: the odd pixel goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
              stride: int = 1, q: Round = exact) -> torch.Tensor:
    """NCHW convolution with ``SAME`` padding and an optional bias."""
    k = w.shape[-1]
    top, bottom = same_pads(x.shape[-2], k, stride)
    left, right = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(q(x), q(w), b, stride)


def group_norm(x: torch.Tensor, groups: int, scale: torch.Tensor,
               shift: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW with the population variance."""
    n, c, h, w = x.shape
    g = x.reshape(n, groups, c // groups * h * w)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(n, c, h, w)
    return y * scale[None, :, None, None] + shift[None, :, None, None]


def linear(x: torch.Tensor, w_out_in: torch.Tensor, b: torch.Tensor,
           q: Round = exact) -> torch.Tensor:
    return q(x) @ q(w_out_in).t() + b


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(H, W, C) -> (H/f, W/f, f*f*C), channels ``[row-phase, col-phase,
    C]``."""
    h, w, c = x.shape
    x = x.reshape(h // f, f, w // f, f, c).permute(0, 2, 1, 3, 4)
    return x.reshape(h // f, w // f, f * f * c)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    h, w, c = x.shape
    c0 = c // (f * f)
    x = x.reshape(h, w, f, f, c0).permute(0, 2, 1, 3, 4)
    return x.reshape(h * f, w * f, c0)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows whose mask is 1."""
    per = F.cross_entropy(logits, labels.long(), reduction="none")
    m = mask.to(per.dtype)
    return (per * m).sum() / m.sum().clamp(min=1.0)
