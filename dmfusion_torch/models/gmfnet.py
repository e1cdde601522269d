"""GMFNet — gated multimodal fusion network (the default model).

Port of ``dmfusion/models/gmfnet.py``: ``Net(cfg)`` called as
``model(ms, pan)`` on a (B, ps, ps, C) MS window and the paired
(B, 4ps, 4ps, 1) PAN window (NHWC, as in the JAX package), returning
(B, classes) float32 logits.  Both branches reach MS resolution at width
``w``; a per-channel sigmoid gate ``z`` fuses them as
``z * h_ms + (1 - z) * h_pan``; a two-stage strided residual trunk and an
MLP head classify.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmfusion_torch.models.common import (ConvBlock, MLPHead, PanPyramid,
                                          PanSpaceToDepth, ResBlock,
                                          activation_fn, dtypes,
                                          tree_shape)
from dmfusion_torch.models.registry import register


@register("gmfnet")
class Net(nn.Module):
    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The config keys that size the model, read from its flax param
        tree: the width (the MS stem is w // 2 wide) and the PAN branch."""
        return {"model_width": 2 * tree_shape(tree, "ConvBlock_0", "Conv_0",
                                              "kernel")[-1],
                "gmfnet_pan": ("pyramid" if "PanPyramid_0" in tree
                               else "s2d")}

    def __init__(self, cfg: Mapping[str, Any], width: int = 64):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        w = int(cfg.get("model_width", width))
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        self.pan_kind = str(cfg.get("gmfnet_pan", "s2d"))

        self.ms_stem = ConvBlock(ms_channels, w // 2, 3, 1, act)
        self.ms_res = ResBlock(w // 2, w, 1, act)
        pan_cls = PanPyramid if self.pan_kind == "pyramid" else PanSpaceToDepth
        self.pan = pan_cls(1, (w // 2, w), act)
        self.pan_res = ResBlock(w, w, 1, act)
        self.fusion_gate = nn.Conv2d(2 * w, w, 1)
        self.trunk = nn.Sequential(ResBlock(w, 2 * w, 2, act),
                                   ResBlock(2 * w, 2 * w, 1, act),
                                   ResBlock(2 * w, 4 * w, 2, act))
        self.head = MLPHead(4 * w, int(cfg["Categories_Number"]),
                            hidden=2 * w, act=act)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        # NHWC in; the NCHW view of an NHWC tensor is channels-last memory.
        ms = ms.permute(0, 3, 1, 2)
        pan = pan.permute(0, 3, 1, 2)
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            h_ms = self.ms_res(self.ms_stem(ms))
            h_pan = self.pan_res(self.pan(pan))
            z = torch.sigmoid(self.fusion_gate(torch.cat([h_ms, h_pan], dim=1)))
            fused = z * h_ms + (1.0 - z) * h_pan
            return self.head(self.trunk(fused))
