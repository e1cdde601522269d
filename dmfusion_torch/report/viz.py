"""Sample-tile grids of the two-stage solver's stage 1.

Port of ``dmfusion/report/viz.py::save_image_grid``, written through the
port's own PNG writer (``report/png.py``) instead of PIL, which the
machine with the card may lack.  The pixels are the same.
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
