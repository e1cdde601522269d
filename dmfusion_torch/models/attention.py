"""Shared attention blocks for the transformer models.

Port of ``dmfusion/models/attention.py``: pre-norm multi-head self and
cross attention blocks with an MLP, on (B, tokens, dim) tensors, and the
learned patch embedding.  flax's arithmetic is kept:
  * ``LayerNorm`` epsilon 1e-6 (:class:`~dmfusion_torch.models.common.LayerNorm`);
  * ``MultiHeadDotProductAttention`` divides the query by
    ``sqrt(head_dim)``, rounded to the compute dtype, *before* the QK
    product, takes the softmax in the compute dtype and projects through
    ``query``/``key``/``value`` kernels of shape ``(dim, heads,
    head_dim)`` and an ``out`` kernel of shape ``(heads, head_dim, dim)``
    (here ``nn.Linear`` layers over the flattened head axes, heads
    major; the converter reshapes them);
  * the MLP's activation is the config's (``Gelu`` is the tanh form).

Attention is an explicit ``softmax(q kᵀ) v`` in plain tensor ops, one
order of operations on every backend; dmfusion computes it outside any
Pallas kernel too.

Under the mesh's ``model`` axis, when the placement shards the heads
(``parallel/partition.py``: the head count divides the axis), a rank
computes its own heads' ``softmax(q kᵀ) v``: ``query``, ``key`` and
``value`` give its heads' features and biases with no gather, and
``out`` is row-parallel (its heads' rows of the product, the peers'
partial sums added, then the whole bias, once).  Otherwise the layer runs
every head, its MLP's denses column-sharded like any other.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch import nn

from dmfusion_torch.models.common import (LayerNorm, Linear, SameConv2d,
                                          tree_shape)
from dmfusion_torch.parallel.tensor import copy_to_model


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads=heads,
    qkv_features=dim)``: queries from ``q_in``, keys and values from
    ``kv_in``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"embed dim {dim} is not a multiple of {heads} "
                             f"heads")
        self.heads = heads
        self.head_dim = dim // heads
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim)
        self.value = Linear(dim, dim)
        self.out = Linear(dim, dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, h * head_dim) -> (B, h, N, head_dim): every head, or this
        rank's under sharded heads."""
        b, n, d = x.shape
        return x.reshape(b, n, d // self.head_dim,
                         self.head_dim).transpose(1, 2)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        tp = self.query.tp
        if tp is not None and tp.mode == "heads":
            # The peers' input gradients (each of its own heads) summed.
            same = kv_in is q_in
            q_in = copy_to_model(q_in, tp.axis)
            kv_in = q_in if same else copy_to_model(kv_in, tp.axis)
        q = self._split(self.query(q_in))
        k = self._split(self.key(kv_in))
        v = self._split(self.value(kv_in))
        # flax: query / jnp.sqrt(depth).astype(dtype), a float32 sqrt.
        q = q / torch.tensor(q.shape[-1] ** 0.5,
                             dtype=torch.float32).to(q.dtype)
        scores = q @ k.transpose(-1, -2)
        # The softmax in the compute dtype, as flax's; autocast's would
        # widen it to float32.
        with torch.autocast(scores.device.type, enabled=False):
            weights = torch.softmax(scores, dim=-1)
        o = (weights @ v).transpose(1, 2)
        return self.out(o.reshape(*o.shape[:2], -1))


class _MLP(nn.Module):
    def __init__(self, dim: int, act: Callable):
        super().__init__()
        self.fc_0 = Linear(dim, 4 * dim)
        self.fc_1 = Linear(4 * dim, dim)
        self.act = act

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_1(self.act(self.fc_0(x)))


class SelfAttnBlock(_MLP):
    """x + attn(LN(x)), then + MLP(LN(.))."""

    def __init__(self, dim: int, heads: int, act: Callable):
        super().__init__(dim, act)
        self.ln_0 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln_1 = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln_0(x)
        x = x + self.attn(y, y)
        return x + self.mlp(self.ln_1(x))


class CrossAttnBlock(_MLP):
    """Queries from stream ``a`` attend to keys and values of stream
    ``b``: a + attn(LN(a), LN(b)), then + MLP(LN(.))."""

    def __init__(self, dim: int, heads: int, act: Callable):
        super().__init__(dim, act)
        self.ln_0 = LayerNorm(dim)
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln_2 = LayerNorm(dim)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a = a + self.attn(self.ln_0(a), self.ln_1(b))
        return a + self.mlp(self.ln_2(a))


class PatchEmbed(SameConv2d):
    """(B, C, H, W) -> (B, H*W/patch², dim): a ``patch`` x ``patch`` conv
    at stride ``patch``, tokens in row-major order (flax's reshape of the
    NHWC output)."""

    def __init__(self, in_features: int, dim: int, patch: int):
        super().__init__(in_features, dim, patch, patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).flatten(2).transpose(1, 2)


def trans_from_tree(tree: Mapping[str, Any], pos: str,
                    block: str) -> dict[str, int]:
    """The ``trans`` widths of a transformer's flax param tree: the embed
    dim from the position embedding ``pos``, the heads from the first
    ``block``'s ``query`` kernel (``(dim, heads, head_dim)``), the depth
    from the count of ``block``s."""
    return {"embed_dim": tree_shape(tree, pos)[-1],
            "num_head": tree_shape(tree, f"{block}0",
                                   "MultiHeadDotProductAttention_0",
                                   "query", "kernel")[1],
            "depth": sum(k.startswith(block) for k in tree)}
