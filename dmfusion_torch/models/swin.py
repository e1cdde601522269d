"""swin_transformer — windowed-attention classifier on the fused patch.

Port of ``dmfusion/models/swin.py``: ``Net(cfg)`` called as ``model(ms,
pan)``, sized by the config's ``trans`` block (``window_size``,
``embed_dim``, ``depths`` and ``num_heads`` per stage).  The PAN window is
conv-pooled 4x to MS resolution (``PanPyramid((dim/2, dim/2))``) and
concatenated with MS on channels; a Swin encoder then embeds the grid,
adds a learned ``pos`` embedding and runs its stages: window attention
with a learned relative-position bias, every second block on windows
cyclically shifted by half a window (with the -100 mask between tokens
of different pre-shift regions), and a 2x2 patch merge between stages.
The token grid is NHWC throughout.  flax's arithmetic is kept:
  * ``ws = min(window, h, w)`` per block, and the shift taken modulo it;
  * the scores are divided by ``sqrt(head_dim)`` computed in the compute
    dtype (bf16 ``sqrt(32)`` is 5.65625), after the QK product;
  * the bias table of shape ``((2 ws - 1)², heads)`` is read through
    ``_relative_index``, and bias and mask are added in the compute dtype;
  * the softmax runs in float32 and is cast back;
  * LayerNorm epsilon 1e-6; the MLP's activation is the config's.

On the mesh's model axis every dense layer is column-parallel
(``models/common.py``'s ``Linear``: the fused ``qkv``'s output is gathered
whole before it is split into q, k and v), and ``pos`` and a bias table
whose heads the rule shards are gathered on use.

Each shifted block's mask is a numpy copy of dmfusion's, built once for
the block's grid (the grid is fixed by ``patch_size``) and held as a
buffer that is not a parameter.

The projections are per token, so they commute with the shift and the
partition: ``qkv`` and ``proj`` run on the (B, H, W, C) grid, and between
them the attention core (``ops/attention.py::window_attn``) takes the grid
and does the roll, the partition, the core, the reverse and the roll back.
On the card, where autograd records nothing, that is B6, one kernel with
the shift and the partition in its addressing and the scores, bias and
mask in float32 up to the softmax; everywhere else (training, the CPU) its
plain version, and each such call on the card counts one on
``window_attn_cuda.bypassed``.  The core is the span ``swin.attn``
(``dmfusion_torch/trace.py``; the projections lie outside it), and every
call counts one on ``WindowAttention.calls`` and, under a shift mask, on
``WindowAttention.masked``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from dmfusion_torch.models.common import (LayerNorm, Linear, MLPHead,
                                          PanPyramid, activation_fn, dtypes,
                                          tree_shape)
from dmfusion_torch.models.registry import register
from dmfusion_torch.ops.attention import window_attn
from dmfusion_torch.parallel.tensor import use
from dmfusion_torch.trace import span


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask: -100 between tokens whose pre-shift
    regions differ (cyclic shift wraps non-adjacent content into the same
    window)."""
    img = np.zeros((h, w), np.int32)
    region = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = region
            region += 1
    img = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    img = img.reshape(-1, ws * ws)                    # (nW, N)
    diff = img[:, :, None] != img[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head attention within (shifted) windows of a grid + learned
    relative-position bias, masked for shifted windows."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.window = window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                 heads))

    def flax_init(self, generator: torch.Generator) -> None:
        """The bias table: normal(0.02), as flax's initializer."""
        self.rel_bias.copy_(0.02 * torch.randn(self.rel_bias.shape,
                                               generator=generator))

    #: Calls of the attention core (the ``swin.attn`` span), and those
    #: among them under a shift mask, over every instance.
    calls = 0
    masked = 0

    def forward(self, y: torch.Tensor, mask: torch.Tensor | None,
                shift: int) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C): ``qkv`` on the grid, the core on
        windows shifted by ``shift`` (under ``mask``), ``proj`` on the
        grid."""
        qkv = self.qkv(y)
        WindowAttention.calls += 1
        WindowAttention.masked += int(mask is not None)
        with span("swin.attn"):
            out = window_attn(qkv, use(self, "rel_bias"), mask, self.window,
                              shift, self.heads)
        return self.proj(out)


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual, LN -> MLP ->
    residual, on an (h, w) grid of ``dim`` channels."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 grid: tuple[int, int], act: Callable):
        super().__init__()
        h, w = grid
        self.ws = min(window, h, w)
        self.shift = shift % self.ws
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, self.ws)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Linear(dim, 4 * dim)
        self.fc2 = Linear(4 * dim, dim)
        self.act = act
        mask = (torch.from_numpy(_shift_mask(h, w, self.ws, self.shift))
                if self.shift else None)
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), self.mask, self.shift)
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


class PatchMerge(nn.Module):
    """2x2 neighbours -> 4C channels (row offset major, as flax's reshape
    orders them) -> LN -> dense to ``dim_out``."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduce = Linear(4 * dim, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        return self.reduce(self.norm(x))


class SwinEncoder(nn.Module):
    """Stages of shifted-window blocks with patch merging in between, on a
    ``grid`` x ``grid`` token grid of ``in_features`` channels (NHWC);
    returns the pooled (B, out_dim) features."""

    def __init__(self, cfg: Mapping[str, Any], in_features: int, grid: int,
                 act: Callable):
        super().__init__()
        tr = cfg["trans"]
        dim = int(tr["embed_dim"])
        ws = int(tr["window_size"])
        depths = [int(d) for d in tr["depths"]]
        heads = [int(nh) for nh in tr["num_heads"]]
        self.embed = Linear(in_features, dim)
        self.pos = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleList()
        h = w = grid
        for s, (depth, nh) in enumerate(zip(depths, heads)):
            self.stages.append(nn.ModuleList(
                SwinBlock(dim, nh, ws, (i % 2) * (ws // 2), (h, w), act)
                for i in range(depth)))
            if s + 1 < len(depths) and h >= 2 and w >= 2:
                self.merges.append(PatchMerge(dim, 2 * dim))
                dim, h, w = 2 * dim, h // 2, w // 2
        self.norm = LayerNorm(dim)
        self.out_dim = dim

    def flax_init(self, generator: torch.Generator) -> None:
        """The position embedding: normal(0.02), as flax's initializer."""
        self.pos.copy_(0.02 * torch.randn(self.pos.shape, generator=generator))

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        x = self.embed(grid)
        x = x + use(self, "pos").to(x.dtype)
        for s, blocks in enumerate(self.stages):
            for block in blocks:
                x = block(x)
            if s < len(self.merges):
                x = self.merges[s](x)
        return self.norm(x).mean(dim=(1, 2))


def swin_trans_from_tree(tree: Mapping[str, Any]) -> dict[str, Any]:
    """The ``trans`` widths of a ``SwinEncoder``'s flax tree: the embed dim
    from ``embed``, the depth of each stage from its block count, the heads
    of each stage from its first block's bias table columns, the window
    from stage 0's table rows, ``(2 ws - 1)²``."""
    depths, heads, s = [], [], 0
    while f"stage{s}_block0" in tree:
        depths.append(sum(k.startswith(f"stage{s}_block") for k in tree))
        heads.append(tree_shape(tree, f"stage{s}_block0", "WindowAttention_0",
                                "rel_bias")[1])
        s += 1
    rows = tree_shape(tree, "stage0_block0", "WindowAttention_0",
                      "rel_bias")[0]
    return {"embed_dim": tree_shape(tree, "embed", "kernel")[1],
            "window_size": (math.isqrt(rows) + 1) // 2,
            "depths": depths, "num_heads": heads}


@register("swin_transformer")
class Net(nn.Module):
    flax_root = "Swin"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The ``trans`` widths, from the encoder's flax tree."""
        return {"trans": swin_trans_from_tree(tree["encoder"])}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        dim = int(cfg["trans"]["embed_dim"])
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        self.pan = PanPyramid(1, (dim // 2, dim // 2), act)
        self.encoder = SwinEncoder(cfg, ms_channels + dim // 2,
                                   int(cfg["patch_size"]), act)
        self.head = MLPHead(self.encoder.out_dim,
                            int(cfg["Categories_Number"]), hidden=dim,
                            act=act)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            pan_feat = self.pan(pan.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            grid = torch.cat([ms.to(pan_feat.dtype), pan_feat], dim=-1)
            return self.head(self.encoder(grid))
