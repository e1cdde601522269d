"""discriminator — the PatchGAN discriminator of the two-stage solver's
stage 1.

Port of ``dmfusion/models/discriminator.py``: two instances, disc_P and
disc_M, score real against generated tiles.  ``Net(cfg)`` called as
``model(x)`` on an NHWC (B, pic, pic, C) tensor returns the NHWC
(B, pic/8, pic/8, 1) float32 realness map:
ConvBlock(w, 4, stride 2, no norm) -> ConvBlock(2w, 4, stride 2) ->
ConvBlock(4w, 4, stride 2) -> Conv(1, 4), with ``w = gan_width`` (default
32) and flax's ``leaky_relu`` (slope 0.01) whatever the config's
activation.  The last conv runs in float32; its 4x4 SAME padding at stride
1 is (1, 2), the odd pixel after (``SameConv2d``).  Its flax tree is
rooted at ``Net``, so the converter reads it under a scope of its own,
``flax_root = "Discriminator"``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dmfusion_torch.models.common import (ConvBlock, SameConv2d, dtypes,
                                          tree_shape)
from dmfusion_torch.models.registry import register


@register("discriminator")
class Net(nn.Module):
    flax_root = "Discriminator"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """``gan_width``, from the flax tree's first conv."""
        return {"gan_width": tree_shape(tree, "ConvBlock_0", "Conv_0",
                                        "kernel")[-1]}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        self.compute_dtype, _ = dtypes(cfg)
        w = int(cfg.get("gan_width", 32))
        channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        act = F.leaky_relu  # flax's nn.leaky_relu: slope 0.01
        self.blocks = nn.Sequential(
            ConvBlock(channels, w, 4, 2, act, norm=False),
            ConvBlock(w, 2 * w, 4, 2, act),
            ConvBlock(2 * w, 4 * w, 4, 2, act))
        self.out = SameConv2d(4 * w, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            x = self.blocks(x)
        with torch.autocast(x.device.type, enabled=False):
            return self.out(x.float()).permute(0, 2, 3, 1)
