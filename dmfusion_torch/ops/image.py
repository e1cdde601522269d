"""Rendering and scene tiling utilities.

The port's copy of ``dmfusion/ops/image.py`` (numpy only; dmfusion's
package imports JAX, so the port keeps its own).  It covers the
reference's visualization helpers (``equalize_histogram`` / ``xianhua``,
solver/mainsolver.py:211-243 and function/function.py:231-238) and the
stage-1 scene <-> tile conversions (``data_process_dqtl_stage1`` tiling
loops, function/function.py:219-227, and ``pan_pic_product``,
function/function.py:136-146) as reshapes instead of Python loops.
"""

from __future__ import annotations

import numpy as np


def equalize_histogram(band: np.ndarray) -> np.ndarray:
    """Classic CDF histogram equalization of a uint8 band
    (reference function/function.py:231-238)."""
    hist, _ = np.histogram(band.flatten(), 256, [0, 256])
    cdf = hist.cumsum()
    cdf_m = np.ma.masked_equal(cdf, 0)
    cdf_m = (cdf_m - cdf_m.min()) * 255 / (cdf_m.max() - cdf_m.min())
    lut = np.ma.filled(cdf_m, 0).astype("uint8")
    return lut[band]


def render_tensor(img: np.ndarray, equalize: bool = True) -> np.ndarray:
    """CHW float tensor -> displayable HW3 (MS, bands 2,1,0) or HW (PAN)
    uint8 image with per-band min-max stretch + optional equalization
    (reference ``xianhua``, solver/mainsolver.py:211-243)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] >= 3:
        bands = img[(2, 1, 0), :, :]
        out = []
        for band in bands:
            lo, hi = band.min(), band.max()
            scaled = ((band - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
            out.append(equalize_histogram(scaled) if equalize else scaled)
        return np.dstack(out)
    band = img[0] if img.ndim == 3 else img
    lo, hi = band.min(), band.max()
    scaled = ((band - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
    return equalize_histogram(scaled) if equalize else scaled


def discover_palette(label: np.ndarray, gt_image: np.ndarray,
                     num_classes: int) -> list[list[int]]:
    """Recover the class palette from a ground-truth rendering.

    Working version of the reference's ``colorlist`` scratch tool
    (function/function.py:20-31): for each class id, return the first
    non-black GT pixel color at that class's locations ([0,0,0] if the
    class never appears or is always black).
    """
    label = np.asarray(label)
    gt = np.asarray(gt_image)
    palette = []
    for cls in range(num_classes):
        xs, ys = np.nonzero(label == cls)
        color = [0, 0, 0]
        for x, y in zip(xs, ys):
            px = gt[x, y]
            if int(np.sum(px)) != 0:
                color = [int(v) for v in px[:3]]
                break
        palette.append(color)
    return palette


def read_tfw(path: str) -> dict:
    """Parse a TIFF world file (reference ``read_tfw``,
    function/function.py:92-96 just prints it; here the six affine
    parameters are returned)."""
    with open(path) as f:
        vals = [float(line.strip()) for line in f if line.strip()]
    keys = ["pixel_size_x", "rot_y", "rot_x", "pixel_size_y",
            "upper_left_x", "upper_left_y"]
    return dict(zip(keys, vals))


def scene_to_tiles(img: np.ndarray, tile: int) -> tuple[np.ndarray, int, int]:
    """(H, W, C) -> (n_tiles, tile, tile, C) with reflect-101 padding to a
    tile multiple; returns (tiles, rows, cols).  Replaces the double
    Python loop in function/function.py:219-227."""
    h, w = img.shape[:2]
    rows, cols = -(-h // tile), -(-w // tile)
    pad = [(0, rows * tile - h), (0, cols * tile - w)] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img, pad, mode="reflect")
    x = x.reshape(rows, tile, cols, tile, *img.shape[2:])
    x = np.moveaxis(x, 2, 1).reshape(rows * cols, tile, tile, *img.shape[2:])
    return x, rows, cols


def tiles_to_scene(tiles: np.ndarray, rows: int, cols: int,
                   size: tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`scene_to_tiles`, cropped to the true scene size
    (reference ``pan_pic_product``, function/function.py:136-146)."""
    n, tile = tiles.shape[0], tiles.shape[1]
    assert n == rows * cols, (n, rows, cols)
    rest = tiles.shape[3:]
    x = tiles.reshape(rows, cols, tile, tile, *rest)
    x = np.moveaxis(x, 2, 1).reshape(rows * tile, cols * tile, *rest)
    return x[: size[0], : size[1]]
