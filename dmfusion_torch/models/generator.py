"""generator — the image generator of the two-stage solver's stage 1.

Port of ``dmfusion/models/generator.py``: two instances, gen_P and gen_M,
map a noise image to a fake pseudo-PAN and a fake MS tile.  ``Net(cfg)``
called as ``model(x)`` on an NHWC (B, pic, pic, C) tensor returns the same
shape, float32 in [0, 1]:
ConvBlock(w, 7) -> ConvBlock(2w, 3, stride 2) -> 2 x ResBlock(2w) ->
nearest 2x upsample -> ConvBlock(w, 3) -> Conv(C, 7) -> sigmoid, with
``w = gan_width`` (default 32).  The last conv and the sigmoid run in
float32 whatever the compute dtype, as flax's ``nn.Conv(dtype=float32)``
does.  Its flax tree is rooted at ``Net``, so the converter reads it under
a scope of its own, ``flax_root = "Generator"``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dmfusion_torch.models.common import (ConvBlock, ResBlock, SameConv2d,
                                          activation_fn, dtypes, tree_shape)
from dmfusion_torch.models.registry import register


@register("generator")
class Net(nn.Module):
    flax_root = "Generator"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """``gan_width``, from the flax tree's first conv."""
        return {"gan_width": tree_shape(tree, "ConvBlock_0", "Conv_0",
                                        "kernel")[-1]}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        w = int(cfg.get("gan_width", 32))
        channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        self.enc1 = ConvBlock(channels, w, 7, 1, act)
        self.enc2 = ConvBlock(w, 2 * w, 3, 2, act)
        self.res = nn.Sequential(ResBlock(2 * w, 2 * w, 1, act),
                                 ResBlock(2 * w, 2 * w, 1, act))
        self.dec = ConvBlock(2 * w, w, 3, 1, act)
        self.out = SameConv2d(w, channels, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC in; the NCHW view of an NHWC tensor is channels-last memory.
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            x = self.res(self.enc2(self.enc1(x)))
            # Decoder: nearest upsample (flax's two jnp.repeat) + conv.
            x = self.dec(F.interpolate(x, scale_factor=2, mode="nearest"))
        with torch.autocast(x.device.type, enabled=False):
            return torch.sigmoid(self.out(x.float())).permute(0, 2, 3, 1)
