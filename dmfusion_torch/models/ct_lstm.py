"""ct_lstm — contourlet multiscale features + recurrent fusion.

Port of ``dmfusion/models/ct_lstm.py``: ``Net(cfg)`` called as
``model(ms, pan)``.  The PAN window is decomposed three times by the
contourlet transform (``ops/contourlet.py``; 64 -> 32 -> 16 -> 8 at patch
16, each level on the previous lowband) and the MS window once.  Each
level's lowband and 4 directional subbands go through a
:class:`LevelEmbed` (a ``ConvBlock`` at stride 1, one at stride 2, a
spatial mean) to one token; the tokens (PAN levels 0, 1, 2, then MS) feed
an LSTM whose last state goes to an MLP head.

The transform runs in float32 whatever the compute dtype, as dmfusion's
("filters are f32 constants"); the embeddings and the LSTM run in the
compute dtype.  The LSTM is flax's ``nn.RNN(OptimizedLSTMCell(dim))``,
written out as a loop of two dense products a step (:class:`LSTM`), not
``nn.LSTM``, whose fused kernels round otherwise under bf16.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dmfusion_torch.models.common import (ConvBlock, MLPHead, activation_fn,
                                          dtypes, tree_shape)
from dmfusion_torch.models.registry import register
from dmfusion_torch.ops.contourlet import contourlet_decompose
from dmfusion_torch.parallel.tensor import use


class LevelEmbed(nn.Module):
    """(lowband, subbands) of one level -> one (B, dim) token."""

    def __init__(self, in_features: int, dim: int, act: Callable):
        super().__init__()
        self.blocks = nn.Sequential(ConvBlock(in_features, dim, 3, 1, act),
                                    ConvBlock(dim, dim, 3, 2, act))

    def forward(self, low: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
        return self.blocks(torch.cat([low, sub], dim=1)).mean(dim=(2, 3))


class LSTM(nn.Module):
    """flax ``nn.RNN(OptimizedLSTMCell(features))`` over a (B, T, in)
    sequence, returning the last hidden state.  The four gates are stacked
    on dimension 0 in the order i, f, g, o: ``input_weight`` ``(4, h,
    in)`` holds flax's ``ii``, ``if``, ``ig``, ``io`` kernels (no bias),
    ``hidden_weight`` ``(4, h, h)`` and ``hidden_bias`` ``(4, h)`` its
    ``hi``, ``hf``, ``hg``, ``ho`` kernels and biases, each gate in
    ``nn.Linear`` layout.  Each step: ``gates = dense_h(h) + dense_i(x)``
    on the stacks flattened to ``(4h, .)``; ``i, f, o`` sigmoid, ``g``
    tanh; ``c = f c + i g``; ``h = o tanh(c)``.  The carry starts at zero
    in float32 (flax's ``param_dtype``), so under bf16 the gates are bf16
    and the carry stays float32, as in flax.

    On the mesh's model axis every gate kernel shards its hidden columns,
    dimension 1 of both weights (``parallel/partition.py``); the cell
    gathers them on use, once a forward (``tp_mode``), and the bias stays
    whole."""

    tp_mode = "gather"

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.input_weight = nn.Parameter(torch.zeros(4, features,
                                                     in_features))
        self.hidden_weight = nn.Parameter(torch.zeros(4, features, features))
        self.hidden_bias = nn.Parameter(torch.zeros(4, features))

    def flax_init(self, generator: torch.Generator) -> None:
        """flax's initializers: the input kernels LeCun normal, each
        gate's recurrent kernel orthogonal, the biases zero.  The draws
        are made on the (CPU) generator's device and copied in."""
        w = torch.randn(self.input_weight.shape, generator=generator)
        self.input_weight.copy_(w / self.input_weight.shape[2] ** 0.5)
        q = torch.empty(4, self.features, self.features)
        for gate in q:
            nn.init.orthogonal_(gate, generator=generator)
        self.hidden_weight.copy_(q)
        self.hidden_bias.zero_()

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        b, steps, _ = seq.shape
        w_in = use(self, "input_weight")
        w_in = w_in.reshape(-1, w_in.shape[-1])
        w_h = use(self, "hidden_weight").reshape(-1, self.features)
        bias = self.hidden_bias.reshape(-1)
        c = h = seq.new_zeros(b, self.features, dtype=torch.float32)
        for t in range(steps):
            gates = (F.linear(h, w_h, bias) + F.linear(seq[:, t], w_in))
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h


@register("ct_lstm")
class Net(nn.Module):
    flax_root = "CTLSTM"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """``model_width``, from the first level's stride-1 conv."""
        return {"model_width": tree_shape(tree, "pan_level0", "ConvBlock_0",
                                          "Conv_0", "kernel")[3]}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        self.compute_dtype, _ = dtypes(cfg)
        dim = int(cfg.get("model_width", 64))
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        self.pan_levels = nn.ModuleList(LevelEmbed(5, dim, act)
                                        for _ in range(3))
        self.ms_level = LevelEmbed(5 * ms_channels, dim, act)
        self.lstm = LSTM(dim, dim)
        self.head = MLPHead(dim, int(cfg["Categories_Number"]), hidden=dim,
                            act=act)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        tokens = []
        x = pan.permute(0, 3, 1, 2)
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            for level in self.pan_levels:
                low, sub = contourlet_decompose(x)
                tokens.append(level(low, sub))
                x = low
            low, sub = contourlet_decompose(ms.permute(0, 3, 1, 2))
            tokens.append(self.ms_level(low, sub))
            return self.head(self.lstm(torch.stack(tokens, dim=1)))
