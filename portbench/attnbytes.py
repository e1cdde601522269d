"""Bytes a window-attention core must move, from the configuration's
shapes.

The core is ``softmax(q k^T / sqrt(hd) + bias [+ mask]) v`` in every
window and head of a grid: from the split of the fused qkv projection to
the product with v.  The least it must move, whatever implements it:

* q, k and v read once and the output written once, in the compute
  dtype: four (windows, tokens, channels) tensors an anchor;
* the relative-position bias table ((2 ws - 1)^2, heads) read once a
  call, in float32, as the parameter is held;
* a shifted call's mask, one (tokens, tokens) float32 slab a window of
  the grid, read once a call.

The scores and probabilities need not leave the chip: a fused core keeps
them on it.  The calls of one forward come from the configuration's
reference (``attention_calls``), so the count follows the model's shapes,
not the kernels that run it.
"""

from __future__ import annotations

import math
from typing import Sequence

from portbench.bytecount import DTYPE_BYTES

#: Bytes of an element of the bias table and of the mask (float32).
TABLE_BYTES = 4


def per_anchor(calls: Sequence[tuple], compute_dtype: str) -> int:
    """q, k, v and the output of every call of one forward, an anchor:
    ``calls`` as ``(windows, heads, tokens, head_dim, masked)``."""
    elem = DTYPE_BYTES[compute_dtype]
    return sum(4 * nw * nh * n * hd * elem for nw, nh, n, hd, _ in calls)


def per_forward(calls: Sequence[tuple]) -> int:
    """The bias tables and masks of every call of one forward, read once
    a call whatever the batch."""
    total = 0
    for nw, nh, n, _, masked in calls:
        ws = math.isqrt(n)
        total += (2 * ws - 1) ** 2 * nh * TABLE_BYTES
        if masked:
            total += nw * n * n * TABLE_BYTES
    return total


def window_attention(calls: Sequence[tuple], anchors: int, forwards: int,
                     compute_dtype: str) -> int:
    """The least bytes of ``forwards`` forwards over ``anchors`` anchors
    in all."""
    return (anchors * per_anchor(calls, compute_dtype)
            + forwards * per_forward(calls))
