"""Image grids: stage 1's sample tiles and the ``proof`` phase's
contourlet subbands.

Port of ``dmfusion/report/viz.py``'s ``save_image_grid`` and
``channel_grid``, written through the port's own PNG writer
(``report/png.py``) instead of PIL and matplotlib, which the machine with
the card may lack.  ``save_image_grid``'s pixels are dmfusion's;
``channel_grid`` lays the same channels out in the same grid, each
min-max scaled to grey, without matplotlib's titles and colour map.
"""

from __future__ import annotations

import os

import numpy as np

from dmfusion_torch.report.png import write_png


def save_image_grid(images: np.ndarray, path: str | os.PathLike,
                    cols: int = 4) -> None:
    """Tile a (B, H, W, C) float [0,1] batch into one RGB PNG: the first
    three channels, or the first repeated three times."""
    x = np.asarray(images)
    b, h, w = x.shape[:3]
    cols = min(cols, b)
    rows = -(-b // cols)
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(b):
        r, col = divmod(i, cols)
        img = x[i]
        if img.ndim == 2:
            img = img[..., None]
        img = img[..., :3] if img.shape[-1] >= 3 else np.repeat(
            img[..., :1], 3, axis=-1)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = np.clip(
            img * 255, 0, 255).astype(np.uint8)
    write_png(path, canvas)


def channel_grid(tensor: np.ndarray, path: str | os.PathLike,
                 num_channels: int = 8, cols: int = 4) -> None:
    """The first batch element's channels as a grey heatmap grid, one PNG:
    ``min(num_channels, C)`` channels of a (B, H, W, C) or (H, W, C) array,
    row by row in ``cols`` columns, each min-max scaled on its own (a
    constant channel is black) and enlarged by whole pixels to at least 64
    pixels a side; empty cells stay black.  dmfusion's guesses NHWC or NCHW
    from the shape; this one takes channels last."""
    x = np.asarray(tensor, np.float32)
    if x.ndim == 4:
        x = x[0]
    h, w, c = x.shape
    n = min(num_channels, c)
    rows = -(-n // cols)
    scale = max(1, -(-64 // max(h, w)))
    canvas = np.zeros((rows * h * scale, cols * w * scale), np.uint8)
    for i in range(n):
        ch = x[..., i]
        lo, span = ch.min(), ch.max() - ch.min()
        grey = (ch - lo) / span if span > 0 else np.zeros_like(ch)
        cell = np.kron(np.round(grey * 255).astype(np.uint8),
                       np.ones((scale, scale), np.uint8))
        r, col = divmod(i, cols)
        canvas[r * h * scale:(r + 1) * h * scale,
               col * w * scale:(col + 1) * w * scale] = cell
    write_png(path, canvas)
