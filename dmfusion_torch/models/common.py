"""Shared building blocks for the model zoo.

Port of ``dmfusion/models/common.py``.  The modules take NCHW tensors
(callers permute NHWC inputs, which gives channels-last memory) and
reproduce the flax modules' arithmetic:
  * flax ``padding="SAME"`` pads ``(total // 2, total - total // 2)``, so a
    stride-2 3x3 conv on an even size pads ``(0, 1)``, not torch's
    symmetric ``padding=1`` (:class:`SameConv2d`),
  * flax GroupNorm's and LayerNorm's epsilon is 1e-6 (torch's default is
    1e-5), and their output is in the compute dtype: autocast runs
    ``group_norm`` and ``layer_norm`` in float32, so :class:`GroupNorm`
    and :class:`LayerNorm` cast the result back to their input's dtype
    and the activations, gate and residual adds stay in bf16,
  * ``ConvBlock`` picks its group count with a divisor loop, while the
    second norm of ``ResBlock`` takes ``min(8, features)`` groups,
  * flax ``nn.gelu`` is the tanh approximation,
  * the last ``Dense`` of ``MLPHead`` runs in float32 even under bf16
    autocast.

Parameters are float32; ``precision.compute_dtype: bfloat16`` runs the
forward under ``torch.autocast``.

Under the mesh's ``model`` axis (``parallel/partition.py``) a conv or
dense layer whose weight the placement shards computes its shard of the
output features (:class:`SameConv2d`, :class:`Linear`:
``parallel/tensor.py::sharded_product``); unsharded, both are torch's
layers.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmfusion_torch.parallel.tensor import sharded_product, unsharded

GROUPNORM_EPS = 1e-6
LAYERNORM_EPS = 1e-6


def activation_fn(cfg: Mapping[str, Any]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Config-selected nonlinearity (reference config.yml schedule.activate)."""
    name = str(cfg.get("schedule", {}).get("activate", "Relu")).lower()
    return {"relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "silu": F.silu, "tanh": torch.tanh,
            "leakyrelu": F.leaky_relu}[name]


def tree_shape(tree: Mapping[str, Any], *path: str) -> tuple[int, ...]:
    """The shape of the leaf at ``path`` of a flax param tree."""
    for key in path:
        tree = tree[key]
    return tuple(int(d) for d in np.shape(tree))


def dtypes(cfg: Mapping[str, Any]) -> tuple[torch.dtype, torch.dtype]:
    """(compute dtype, parameter dtype) from ``precision``."""
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    prec = cfg.get("precision", {})
    return (names[str(prec.get("compute_dtype", "bfloat16"))],
            names[str(prec.get("param_dtype", "float32"))])


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d with flax/XLA ``SAME`` padding: the odd pixel of padding
    goes after, not before.  Its output channels may be sharded over the
    model axis (``tp``)."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[-2], kh, sh)
        left, right = _same_pads(x.shape[-1], kw, sw)
        pad = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        return sharded_product(
            self, x, lambda x, w, b: F.conv2d(x, w, b, self.stride, pad), 1)


class Linear(nn.Linear):
    """``nn.Linear`` whose output features may be sharded over the model
    axis (``tp``)."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sharded_product(self, x, F.linear, -1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with flax's epsilon whose output keeps the input dtype
    (float32 statistics and affine, as in flax, then one rounding)."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with flax's epsilon, whose output keeps
    the input dtype (float32 statistics and affine, then one rounding)."""

    def __init__(self, features: int):
        super().__init__(features, eps=LAYERNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).to(x.dtype)


def conv_block_groups(features: int) -> int:
    """The largest divisor of ``features`` that is at most 8."""
    groups = min(8, features)
    while features % groups:
        groups -= 1
    return groups


class ConvBlock(nn.Module):
    """Conv -> GroupNorm (unless ``norm`` is off) -> activation."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, act: Callable = F.relu, norm: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_features, features, kernel, stride)
        self.norm = (GroupNorm(conv_block_groups(features), features)
                     if norm else None)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return self.act(x if self.norm is None else self.norm(x))


class ResBlock(nn.Module):
    """Two 3x3 convs with identity (or 1x1-projected) shortcut."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 act: Callable = F.relu):
        super().__init__()
        self.block = ConvBlock(in_features, features, 3, stride, act)
        self.conv = SameConv2d(features, features, 3)
        self.norm = GroupNorm(min(8, features), features)
        self.shortcut = (SameConv2d(in_features, features, 1, stride)
                         if in_features != features or stride != 1 else None)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv(self.block(x)))
        sc = x if self.shortcut is None else self.shortcut(x)
        return self.act(y + sc)


class MLPHead(nn.Module):
    """Global-average-pool -> dense -> classifier logits (float32 out)."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = 0,
                 act: Callable = F.relu):
        super().__init__()
        self.hidden = Linear(in_features, hidden) if hidden else None
        self.out = Linear(hidden or in_features, num_classes)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            x = x.mean(dim=(2, 3))
        if self.hidden is not None:
            x = self.act(self.hidden(x))
        with torch.autocast(x.device.type, enabled=False):
            return self.out(x.float())


class PanPyramid(nn.Module):
    """Strided conv pyramid reducing the 4x PAN window to MS resolution:
    4 x ps -> ps in two stride-2 stages."""

    def __init__(self, in_features: int, features: Sequence[int] = (32, 64),
                 act: Callable = F.relu):
        super().__init__()
        ins = [in_features, *features[:-1]]
        self.blocks = nn.ModuleList(
            ConvBlock(i, f, 3, 2, act) for i, f in zip(ins, features))

    def forward(self, pan: torch.Tensor) -> torch.Tensor:
        x = pan
        for block in self.blocks:
            x = block(x)
        return x


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 4h, 4w) -> (B, 16C, h, w) with channels ordered (dy, dx, c),
    as the flax module's NHWC reshape orders them (``pixel_unshuffle``
    orders them (c, dy, dx))."""
    b, c, h4, w4 = x.shape
    x = x.reshape(b, c, h4 // 4, 4, w4 // 4, 4)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 16 * c, h4 // 4, w4 // 4)


class PanSpaceToDepth(nn.Module):
    """4x space-to-depth + stride-1 convs at MS resolution (same role as
    :class:`PanPyramid`)."""

    def __init__(self, in_features: int, features: Sequence[int] = (32, 64),
                 act: Callable = F.relu):
        super().__init__()
        ins = [16 * in_features, *features[:-1]]
        self.blocks = nn.ModuleList(
            ConvBlock(i, f, 3, 1, act) for i, f in zip(ins, features))

    def forward(self, pan: torch.Tensor) -> torch.Tensor:
        x = space_to_depth4(pan)
        for block in self.blocks:
            x = block(x)
        return x


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization like flax's defaults: conv and dense kernels
    LeCun-normal (variance 1/fan_in), biases zero, norm scales one; a
    module with a ``flax_init(generator)`` method initializes its own
    parameters (the dense family's WSConv, alpha and raw head params, the
    transformers' position, modality and class embeddings).  A model
    sharded over the mesh's model axis draws the whole tensors, as one
    process does, and keeps its shards of them."""
    with torch.no_grad(), unsharded(model):
        for m in model.modules():
            if hasattr(m, "flax_init"):
                m.flax_init(generator)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator,
                                dtype=torch.float32)
                m.weight.copy_(w / fan_in ** 0.5)
                m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model
