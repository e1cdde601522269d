"""tri_net — three-stream fusion (MS + PAN + IHS-fused MSPAN).

Port of ``dmfusion/models/tri_net.py``: ``Net(cfg)`` called as
``model(ms, pan, mspan)`` on a (B, ps, ps, C) MS window and two
(B, 4ps, 4ps, 1) windows at PAN geometry (NHWC), returning (B, classes)
float32 logits.  Each stream reaches MS resolution at width ``w``; a 1x1
``stream_gate`` conv and a softmax over its three channels, in the compute
dtype as in flax, weigh the streams; two strided residual blocks and an
MLP head classify.

Its flax tree is rooted at ``Net`` like gmfnet's but is not gmfnet's
(``ResBlock_2`` is the MSPAN branch here, the trunk's first block there),
so the converter reads it under a scope of its own, ``flax_root =
"TriNet"``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmfusion_torch.models.common import (ConvBlock, MLPHead, PanPyramid,
                                          ResBlock, SameConv2d, activation_fn,
                                          dtypes, tree_shape)
from dmfusion_torch.models.registry import register


@register("tri_net")
class Net(nn.Module):
    flax_root = "TriNet"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The width, from the flax tree's MS stem (w // 2 wide)."""
        return {"model_width": 2 * tree_shape(tree, "ConvBlock_0", "Conv_0",
                                              "kernel")[-1]}

    def __init__(self, cfg: Mapping[str, Any], width: int = 64):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        w = int(cfg.get("model_width", width))
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])

        self.ms_stem = ConvBlock(ms_channels, w // 2, 3, 1, act)
        self.ms_res = ResBlock(w // 2, w, 1, act)
        self.pan = PanPyramid(1, (w // 2, w), act)
        self.pan_res = ResBlock(w, w, 1, act)
        self.mspan = PanPyramid(1, (w // 2, w), act)
        self.mspan_res = ResBlock(w, w, 1, act)
        self.stream_gate = SameConv2d(3 * w, 3, 1)
        self.trunk = nn.Sequential(ResBlock(w, 2 * w, 2, act),
                                   ResBlock(2 * w, 4 * w, 2, act))
        self.head = MLPHead(4 * w, int(cfg["Categories_Number"]),
                            hidden=2 * w, act=act)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor,
                mspan: torch.Tensor) -> torch.Tensor:
        # NHWC in; the NCHW view of an NHWC tensor is channels-last memory.
        ms = ms.permute(0, 3, 1, 2)
        pan = pan.permute(0, 3, 1, 2)
        mspan = mspan.permute(0, 3, 1, 2)
        dev = ms.device.type
        with torch.autocast(dev, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            h_ms = self.ms_res(self.ms_stem(ms))
            h_pan = self.pan_res(self.pan(pan))
            h_mp = self.mspan_res(self.mspan(mspan))
            logits = self.stream_gate(torch.cat([h_ms, h_pan, h_mp], dim=1))
            # flax's softmax runs in the compute dtype; autocast's would
            # run in float32.
            with torch.autocast(dev, enabled=False):
                gate = torch.softmax(logits, dim=1)
            fused = (gate[:, 0:1] * h_ms + gate[:, 1:2] * h_pan
                     + gate[:, 2:3] * h_mp)
            return self.head(self.trunk(fused))
