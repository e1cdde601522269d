"""Dual-branch ResNet-18-style fusion classifier.

Port of ``dmfusion/models/resnet18.py``: ``Net(cfg)`` called as
``model(ms, pan)`` like gmfnet.  Each branch (``ms_branch``,
``pan_branch``) is a stem and the (2, 2, 2, 2) basic-block layout at
widths ``(base, 2 base, 4 base, 8 base)``, ``base = model_width``
(default 32), ending in a spatial mean; the PAN stem has stride 2.  The
two means are concatenated into an MLP head of ``4 base`` hidden units.
GroupNorm stands for BatchNorm, as in dmfusion.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn

from dmfusion_torch.models.common import (ConvBlock, MLPHead, ResBlock,
                                          activation_fn, dtypes,
                                          tree_shape)
from dmfusion_torch.models.registry import register


class Branch(nn.Module):
    def __init__(self, in_features: int, widths: Sequence[int],
                 stem_stride: int, act: Callable):
        super().__init__()
        self.stem = ConvBlock(in_features, widths[0], 3, stem_stride, act)
        blocks, prev = [], widths[0]
        for i, w in enumerate(widths):
            blocks += [ResBlock(prev, w, 1 if i == 0 else 2, act),
                       ResBlock(w, w, 1, act)]
            prev = w
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.stem(x)).mean(dim=(2, 3))


@register("resnet18")
class Net(nn.Module):
    flax_root = "ResNet18"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The base width, from the flax tree's MS stem."""
        return {"model_width": tree_shape(tree, "ms_branch", "ConvBlock_0",
                                          "Conv_0", "kernel")[-1]}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        base = int(cfg.get("model_width", 32))
        widths = (base, 2 * base, 4 * base, 8 * base)
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        self.ms_branch = Branch(ms_channels, widths, 1, act)
        # The PAN stem strides twice as hard to equalise token counts.
        self.pan_branch = Branch(1, widths, 2, act)
        self.head = MLPHead(16 * base, int(cfg["Categories_Number"]),
                            hidden=4 * base, act=act)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        ms = ms.permute(0, 3, 1, 2)
        pan = pan.permute(0, 3, 1, 2)
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            fused = torch.cat([self.ms_branch(ms), self.pan_branch(pan)],
                              dim=-1)
            return self.head(fused)
