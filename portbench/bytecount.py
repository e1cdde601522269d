"""Bytes the port's memory-bound kernels must move, from their shapes and
inputs.

Frozen copies of the counts the port's probes use, so that a later change
to the program cannot move the yardstick, made general over the streams a
call gathers and the sizes a configuration has:

* B1, the window gather (``csrc/gather_windows.cu``): every window byte
  written once, every scene byte that some window covers read once, and
  the int32 ids read once.  The probe
  (``dmfusion_torch/tools/gather_probe.py::moved_bytes``) reads every
  window byte once; where windows overlap (anchors closer than a window,
  as in raster order, and now and then in uniform draws) a byte read for
  one window serves the others from the cache, so the least the kernel
  must read is the scene's covered bytes, counted here exactly;
* B2, the phase window-pool (``csrc/phase_pool.cu``): the s2d-2 features
  read once and the pooled s2d-2 map written once
  (``dmfusion_torch/tools/pool_probe.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def gather(windows: Callable[..., Sequence[torch.Tensor]],
           stream_shapes: Sequence[Sequence[int]],
           calls: Sequence[torch.Tensor], elem_bytes: int) -> int:
    """Family calls, one a tensor of flat anchor ids in ``calls``.
    ``windows(*streams, ids)`` is the reference's plain gather of every
    stream's windows; it is run on index scenes (each element holding its
    own flat index), so that the distinct indices it returns are the
    scene elements a call must read."""
    if not calls:
        return 0
    dev = calls[0].device
    index = [torch.arange(_numel(s), device=dev, dtype=torch.int32
                          ).reshape(tuple(s)) for s in stream_shapes]
    total = 0
    for ids in calls:
        got = windows(*index, ids)
        read = sum(int(torch.unique(w).numel()) for w in got)
        written = sum(int(w.numel()) for w in got)
        total += (read + written) * elem_bytes + 4 * int(ids.numel())
    return total


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for v in shape:
        n *= int(v)
    return n


def phase_pool(features_hw: Sequence[int], pooled_hw: Sequence[int],
               channels: int, compute_dtype: str) -> int:
    """One pool of (Hm, Wm, ``channels``) full-resolution features, packed
    s2d-2 at (ceil(Hm/2), ceil(Wm/2), 4 channels), to the s2d-2 packing of
    the (H, W, ``channels``) window-mean map."""
    h2, w2 = (-(-int(v) // 2) for v in features_hw)
    ni, nj = (-(-int(v) // 2) for v in pooled_hw)
    return (h2 * w2 + ni * nj) * 4 * channels * DTYPE_BYTES[compute_dtype]
