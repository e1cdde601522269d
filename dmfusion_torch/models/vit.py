"""vision_transformer — dual-modality ViT.

Port of ``dmfusion/models/vit.py``: ``Net(cfg)`` called as
``model(ms, pan)``, sized by the config's ``trans`` block (patch_size,
embed_dim, depth, num_head).  MS tokens (``ms_embed`` at
``trans.patch_size``) and PAN tokens (a ``PanPyramid`` to MS resolution,
then ``pan_embed``) each get their learned ``modality`` embedding, then
one ``pos`` embedding over the joined sequence; a learned ``cls`` token
leads it.  ``trans.depth`` pre-norm self-attention blocks (``block_{i}``),
a final LayerNorm and a linear head on the class token give the logits.
At patch 16 and ``trans.patch_size`` 1 the sequence is 513 tokens.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmfusion_torch.models.attention import (PatchEmbed, SelfAttnBlock,
                                             trans_from_tree)
from dmfusion_torch.models.common import (LayerNorm, MLPHead, PanPyramid,
                                          activation_fn, dtypes, tree_shape)
from dmfusion_torch.models.registry import register


@register("vit")
@register("vision_transformer")
class Net(nn.Module):
    flax_root = "ViT"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The ``trans`` widths, the patch from ``ms_embed``'s kernel."""
        return {"trans": {**trans_from_tree(tree, "pos", "block_"),
                          "patch_size": tree_shape(tree, "ms_embed",
                                                   "kernel")[0]}}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        tr = cfg["trans"]
        dim, heads = int(tr["embed_dim"]), int(tr["num_head"])
        depth = int(tr["depth"])
        p = max(int(tr["patch_size"]), 1)
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        tokens = 2 * (int(cfg["patch_size"]) // p) ** 2

        self.ms_embed = PatchEmbed(ms_channels, dim, p)
        self.pan = PanPyramid(1, (dim // 2, dim), act)
        self.pan_embed = PatchEmbed(dim, dim, p)
        self.pos = nn.Parameter(torch.zeros(1, tokens, dim))
        self.modality = nn.Parameter(torch.zeros(2, dim))
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.Sequential(*(SelfAttnBlock(dim, heads, act)
                                      for _ in range(depth)))
        self.norm = LayerNorm(dim)
        self.head = MLPHead(dim, int(cfg["Categories_Number"]), act=act)

    def flax_init(self, generator: torch.Generator) -> None:
        """The position, modality and class embeddings: normal(0.02), as
        flax's initializer."""
        for p in (self.pos, self.modality, self.cls):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        ms = ms.permute(0, 3, 1, 2)
        pan = pan.permute(0, 3, 1, 2)
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            t_ms = self.ms_embed(ms)
            t_pan = self.pan_embed(self.pan(pan))
            dt = t_ms.dtype
            mod = self.modality.to(dt)
            tokens = torch.cat([t_ms + mod[0], t_pan + mod[1]],
                               dim=1) + self.pos.to(dt)
            cls = self.cls.to(dt).expand(tokens.shape[0], 1, -1)
            x = self.norm(self.blocks(torch.cat([cls, tokens], dim=1)))
            return self.head(x[:, 0])
