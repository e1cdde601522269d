"""IHS-style cross-modal resampling ops (reference image_convert/IHS.py).

Port of ``dmfusion/ops/ihs.py``, plain torch on the tensor's device:

  * :func:`block_mean` — mean-pool downsample by strided-slice adds,
  * :func:`pan2ms` — PAN -> pseudo-MS by /2 block-mean then 2x2 phase
    interleave into the channels,
  * :func:`unpooling` — t-times upsample placing each value at a seeded
    random position inside its t x t block,
  * :func:`ihs_transform` — the classic IHS pansharpen that feeds the tri
    arity's MSPAN stream.

The unpooling offsets come from one function, :func:`unpool_offsets`,
drawn on a CPU ``torch.Generator`` as uint8 and moved to the device, so
the CPU and the card build the same MSPAN from one seed (a CUDA
generator's stream differs from the CPU's).  dmfusion draws them from
``jax.random``: the two packages' MSPAN agree to rounding (it collapses
to PAN), and exactly when the offsets are shared.
"""

from __future__ import annotations

import torch


def block_mean(img: torch.Tensor, scale: int) -> torch.Tensor:
    """(H, W) -> (H//scale, W//scale) mean over scale x scale blocks, as
    ``scale**2`` strided-slice adds in row-major block order, then one
    division."""
    h = img.shape[0] - img.shape[0] % scale
    w = img.shape[1] - img.shape[1] % scale
    acc = None
    for i in range(scale):
        for j in range(scale):
            part = img[i:h:scale, j:w:scale]
            acc = part if acc is None else acc + part
    return acc / scale ** 2


def pan2ms(pan: torch.Tensor, size: tuple[int, int, int]) -> torch.Tensor:
    """PAN (4H, 4W) -> pseudo-MS (H, W, C): /2 block-mean, then channel
    ``i`` is the phase ``p[i % 2::2, i // 2::2]``."""
    h, w, c = size
    p = block_mean(pan, 2)
    return torch.stack([p[i % 2::2, i // 2::2][:h, :w] for i in range(c)],
                       dim=-1)


def unpool_offsets(shape: tuple[int, int, int], t: int,
                   generator: torch.Generator
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (row, column) offsets of each value inside its t x t block: two
    uint8 tensors of ``shape`` in [0, t), drawn in that order from
    ``generator`` (a CPU generator), on the CPU."""
    rows = torch.randint(0, t, shape, generator=generator, dtype=torch.uint8)
    cols = torch.randint(0, t, shape, generator=generator, dtype=torch.uint8)
    return rows, cols


def unpooling(img: torch.Tensor, t: int,
              generator: torch.Generator) -> torch.Tensor:
    """(H, W, C) -> (H*t, W*t, C); each value lands at its seeded offset
    inside its t x t block, the rest is zero.  The indices are unique, one
    per (i, j, c), so one ``index_put_`` is exact and deterministic."""
    h, w, c = img.shape
    m, n = unpool_offsets((h, w, c), t, generator)
    dev = img.device
    rows = (torch.arange(h, device=dev)[:, None, None] * t
            + m.to(dev, torch.int64))
    cols = (torch.arange(w, device=dev)[None, :, None] * t
            + n.to(dev, torch.int64))
    chan = torch.arange(c, device=dev)[None, None, :].expand(h, w, c)
    out = torch.zeros((h * t, w * t, c), dtype=img.dtype, device=dev)
    return out.index_put_((rows, cols, chan), img)


def replicate_channels(img: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) -> (H, W, n) channel replicate (reference ``raw_3copy``)."""
    return img[:, :, None].expand(*img.shape, n)


def ihs_transform(ms: torch.Tensor, pan: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Classic IHS pansharpen: unpool MS to PAN geometry, I = channel
    mean, delta = PAN - I, add delta to every band, return the band mean.

    The band mean of (MS_up + delta) equals PAN in exact arithmetic; the
    reference's order of operations is kept, so the rounding is the one
    the model sees."""
    c = ms.shape[2]
    up = unpooling(ms, c, generator)
    intensity = up.mean(dim=2)
    delta = pan - intensity
    result = up + replicate_channels(delta, c)
    del up
    return result.mean(dim=2)


def upsample_nearest(img: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest upsample companion to :func:`block_mean`."""
    return img.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)
