"""dqtl — the shared four-stream classifier of the two-stage solver's stage 2.

Port of ``dmfusion/models/dqtl.py``: ``Net(cfg)`` called as ``model(x)``
on the four aligned MS-geometry streams (MS, ``pan2ms(PAN)``, the GAN's
fake PAN and fake MS) concatenated along the batch axis, a (4B, ps, ps, C)
NHWC tensor, returning (4B, classes) float32 logits:
ConvBlock(w/2) -> ResBlock(w) -> ResBlock(2w, stride 2) -> ResBlock(2w) ->
MLPHead(hidden w).

Its flax tree is rooted at ``Net``, like gmfnet's and tri_net's, with
other layers under the same names, so the converter reads it under a scope
of its own, ``flax_root = "DQTL"``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmfusion_torch.models.common import (ConvBlock, MLPHead, ResBlock,
                                          activation_fn, dtypes, tree_shape)
from dmfusion_torch.models.registry import register


@register("dqtl")
class Net(nn.Module):
    flax_root = "DQTL"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The width, from the flax tree's stem (w // 2 wide)."""
        return {"model_width": 2 * tree_shape(tree, "ConvBlock_0", "Conv_0",
                                              "kernel")[-1]}

    def __init__(self, cfg: Mapping[str, Any], width: int = 64):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        w = int(cfg.get("model_width", width))
        channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])

        self.stem = ConvBlock(channels, w // 2, 3, 1, act)
        self.blocks = nn.Sequential(ResBlock(w // 2, w, 1, act),
                                    ResBlock(w, 2 * w, 2, act),
                                    ResBlock(2 * w, 2 * w, 1, act))
        self.head = MLPHead(2 * w, int(cfg["Categories_Number"]), hidden=w,
                            act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC in; the NCHW view of an NHWC tensor is channels-last memory.
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            return self.head(self.blocks(self.stem(x)))
