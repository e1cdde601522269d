"""Image grids and scatters: stage 1's sample tiles, the ``proof``
phase's contourlet subbands and the ``visualize`` phase's t-SNE scatter.

Port of ``dmfusion/report/viz.py``, written through the port's own PNG
writer (``report/png.py``) instead of PIL and matplotlib, which the
machine with the card may lack.  ``save_image_grid``'s pixels are
dmfusion's; ``channel_grid`` lays the same channels out in the same grid,
each min-max scaled to grey, without matplotlib's titles and colour map;
``embedding_scatter`` embeds the same rows by the port's t-SNE
(``report/tsne.py``) and draws them in matplotlib's colours, its legend a
column of swatches without text.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dmfusion_torch.report.png import write_png
from dmfusion_torch.report.tsne import Embedding, tsne

# matplotlib's "tab20" colours, in its order.
TAB20 = np.array([[int(h[i:i + 2], 16) for i in (0, 2, 4)] for h in (
    "1f77b4", "aec7e8", "ff7f0e", "ffbb78", "2ca02c", "98df8a", "d62728",
    "ff9896", "9467bd", "c5b0d5", "8c564b", "c49c94", "e377c2", "f7b6d2",
    "7f7f7f", "c7c7c7", "bcbd22", "dbdb8d", "17becf", "9edae5")], np.uint8)
# The scatter's canvas (dmfusion's 8 x 6 inch figure at 120 dpi) and its
# axes box, as fractions of the canvas (matplotlib's default margins).
SCATTER_HW = (720, 960)
_AXES = (0.125, 0.9, 0.11, 0.88)  # left, right, bottom, top
_DOT = 2  # dot radius, pixels
_SWATCH, _SWATCH_STEP = 12, 18


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


def scatter_colors(n: int) -> np.ndarray:
    """(n, 3) uint8: the colour of the i-th of ``n`` classes, as
    ``plt.get_cmap("tab20", n)(i)`` picks it (tab20 resampled to n)."""
    idx = np.floor(np.linspace(0.0, 1.0, n) * len(TAB20)).astype(np.int64)
    return TAB20[np.clip(idx, 0, len(TAB20) - 1)]


def _render_scatter(xy: np.ndarray, lab: np.ndarray) -> np.ndarray:
    """The (H, W, 3) uint8 scatter: white canvas, a black axes frame, the
    points as dots in class order (a later class over an earlier one), the
    data range padded by 5 % a side; a swatch per class, top down, right of
    the axes."""
    h, w = SCATTER_HW
    canvas = np.full((h, w, 3), 255, np.uint8)
    left, right = int(_AXES[0] * w), int(_AXES[1] * w)
    top, bottom = int((1 - _AXES[3]) * h), int((1 - _AXES[2]) * h)
    canvas[top:bottom + 1, [left, right]] = 0
    canvas[[top, bottom], left:right + 1] = 0
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    pad = np.where(hi > lo, (hi - lo) * 0.05, 1.0)
    lo, hi = lo - pad, hi + pad
    col = left + (xy[:, 0] - lo[0]) / (hi[0] - lo[0]) * (right - left)
    row = bottom - (xy[:, 1] - lo[1]) / (hi[1] - lo[1]) * (bottom - top)
    col, row = np.rint(col).astype(np.int64), np.rint(row).astype(np.int64)
    disc = [(dr, dc) for dr in range(-_DOT, _DOT + 1)
            for dc in range(-_DOT, _DOT + 1) if dr * dr + dc * dc <= _DOT ** 2]
    classes = np.unique(lab)
    colors = scatter_colors(len(classes))
    for i, c in enumerate(classes):
        m = lab == c
        for dr, dc in disc:
            canvas[row[m] + dr, col[m] + dc] = colors[i]
        r0 = top + 4 + i * _SWATCH_STEP
        if r0 + _SWATCH <= h:
            canvas[r0:r0 + _SWATCH, right + 8:right + 8 + _SWATCH] = colors[i]
    return canvas


def embedding_scatter(embeddings, labels: np.ndarray,
                      path: str | os.PathLike, max_points: int = 2000,
                      seed: int = 0) -> Embedding:
    """2-D t-SNE scatter of the rows of ``embeddings`` (a tensor, embedded
    on its device, or an array), coloured by integer label; returns the
    t-SNE run.  Above ``max_points`` rows, the rows of dmfusion's draw
    (``default_rng(seed).choice(n, max_points, replace=False)``) are
    embedded.  The legend is a column of colour swatches in label order,
    without text (dmfusion's names the two-stage streams M/PAN/GM/GP)."""
    emb = (embeddings if isinstance(embeddings, torch.Tensor)
           else torch.from_numpy(np.asarray(embeddings)))
    lab = np.asarray(labels).astype(int)
    if emb.shape[0] > max_points:
        keep = np.random.default_rng(seed).choice(emb.shape[0], max_points,
                                                  replace=False)
        emb = emb[torch.from_numpy(keep).to(emb.device)]
        lab = lab[keep]
    result = tsne(emb)
    write_png(path, _render_scatter(result.xy.cpu().numpy(), lab))
    return result
