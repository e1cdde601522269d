"""swin_T_dual — two independent Swin branches with late fusion.

Port of ``dmfusion/models/swin_dual.py``: ``Net(cfg)`` called as
``model(ms, pan)``.  MS gets its own :class:`SwinEncoder` (``ms_encoder``)
on its window; PAN is conv-pooled 4x to MS resolution
(``PanPyramid((dim/2, dim))``) and gets another (``pan_encoder``).  The
pooled branch features are fused by a sigmoid gate over both,
``gate · f_ms + (1 − gate) · f_pan``, before an MLP head.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmfusion_torch.models.common import (Linear, MLPHead, PanPyramid,
                                          activation_fn, dtypes)
from dmfusion_torch.models.registry import register
from dmfusion_torch.models.swin import SwinEncoder, swin_trans_from_tree


@register("swin_t_dual")
class Net(nn.Module):
    flax_root = "SwinDual"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The ``trans`` widths, from the MS encoder's flax tree."""
        return {"trans": swin_trans_from_tree(tree["ms_encoder"])}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        dim = int(cfg["trans"]["embed_dim"])
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        grid = int(cfg["patch_size"])
        self.pan = PanPyramid(1, (dim // 2, dim), act)
        self.ms_encoder = SwinEncoder(cfg, ms_channels, grid, act)
        self.pan_encoder = SwinEncoder(cfg, dim, grid, act)
        out = self.ms_encoder.out_dim
        self.gate = Linear(2 * out, out)
        self.head = MLPHead(out, int(cfg["Categories_Number"]), hidden=dim,
                            act=act)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            pan_grid = self.pan(pan.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            f_ms = self.ms_encoder(ms.to(pan_grid.dtype))
            f_pan = self.pan_encoder(pan_grid)
            gate = torch.sigmoid(self.gate(torch.cat([f_ms, f_pan], dim=-1)))
            return self.head(gate * f_ms + (1.0 - gate) * f_pan)
