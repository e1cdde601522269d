"""cross_net — bidirectional cross-attention fusion of MS and PAN tokens.

Port of ``dmfusion/models/cross_net.py``: ``Net(cfg)`` called as
``model(ms, pan)``.  The MS window is embedded at patch 2 (``ms_embed``);
the PAN window is brought to MS resolution by a ``PanPyramid`` and
embedded at patch 2 (``pan_embed``); each grid gets its learned position
embedding (``pos_ms``, ``pos_pan``).  ``trans.depth`` rounds of cross
blocks (``ms_from_pan_{i}``, ``pan_from_ms_{i}``) then self blocks
(``ms_self_{i}``, ``pan_self_{i}``), of ``trans.embed_dim`` and
``trans.num_head``; the two token means feed an MLP head.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmfusion_torch.models.attention import (CrossAttnBlock, PatchEmbed,
                                             SelfAttnBlock, trans_from_tree)
from dmfusion_torch.models.common import (MLPHead, PanPyramid, activation_fn,
                                          dtypes)
from dmfusion_torch.models.registry import register
from dmfusion_torch.parallel.tensor import use


@register("cross_net")
class Net(nn.Module):
    flax_root = "CrossNet"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The ``trans`` widths, from the flax tree."""
        return {"trans": trans_from_tree(tree, "pos_ms", "ms_from_pan_")}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        tr = cfg["trans"]
        dim, heads = int(tr["embed_dim"]), int(tr["num_head"])
        depth = int(tr["depth"])
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        tokens = (int(cfg["patch_size"]) // 2) ** 2

        self.ms_embed = PatchEmbed(ms_channels, dim, 2)
        self.pan = PanPyramid(1, (dim // 2, dim), act)
        self.pan_embed = PatchEmbed(dim, dim, 2)
        self.pos_ms = nn.Parameter(torch.zeros(1, tokens, dim))
        self.pos_pan = nn.Parameter(torch.zeros(1, tokens, dim))
        self.ms_from_pan = nn.ModuleList(
            CrossAttnBlock(dim, heads, act) for _ in range(depth))
        self.pan_from_ms = nn.ModuleList(
            CrossAttnBlock(dim, heads, act) for _ in range(depth))
        self.ms_self = nn.ModuleList(
            SelfAttnBlock(dim, heads, act) for _ in range(depth))
        self.pan_self = nn.ModuleList(
            SelfAttnBlock(dim, heads, act) for _ in range(depth))
        self.head = MLPHead(2 * dim, int(cfg["Categories_Number"]),
                            hidden=dim, act=act)

    def flax_init(self, generator: torch.Generator) -> None:
        """The position embeddings: normal(0.02), as flax's initializer."""
        for p in (self.pos_ms, self.pos_pan):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        ms = ms.permute(0, 3, 1, 2)
        pan = pan.permute(0, 3, 1, 2)
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            t_ms = self.ms_embed(ms)
            t_pan = self.pan_embed(self.pan(pan))
            t_ms = t_ms + use(self, "pos_ms").to(t_ms.dtype)
            t_pan = t_pan + use(self, "pos_pan").to(t_pan.dtype)
            for ms_x, pan_x, ms_s, pan_s in zip(self.ms_from_pan,
                                                self.pan_from_ms,
                                                self.ms_self, self.pan_self):
                t_ms2 = ms_x(t_ms, t_pan)
                t_pan2 = pan_x(t_pan, t_ms)
                t_ms, t_pan = ms_s(t_ms2), pan_s(t_pan2)
            fused = torch.cat([t_ms.mean(dim=1), t_pan.mean(dim=1)], dim=-1)
            return self.head(fused)
