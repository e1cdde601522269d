"""Contourlet decomposition: Laplacian pyramid + directional filter bank.

Port of ``dmfusion/ops/contourlet.py`` on NCHW tensors (dmfusion's is
NHWC; the subband channels are ordered the same, directional band major):

  * the LP stage: the 9/7 biorthogonal pyramid filters as 2-D outer
    products (computed in float64, rounded to float32 once, as
    ``jnp.asarray(kernel2d, x.dtype)`` rounds them), numpy ``"reflect"``
    padding, decimate by 2, zero-upsample, ``high = img -
    smooth(upsampled_low)``;
  * the two-level DFB: the 5x5 diamond fan filters (cross-correlated, as
    XLA's conv does, so the asymmetric ``_H1`` stays unflipped), quincunx
    resampling (Q0, then Q1) and the centre crop, giving 4 directional
    subbands.

The quincunx resample is ``map_coordinates(order=1, mode="constant",
cval=0)`` at the coordinates of torch's ``affine_grid`` (align_corners,
zero padding): each output reads its two-by-two neighbours with bilinear
weights, and a neighbour outside the image reads 0.  The coordinates,
neighbours and weights depend only on the shape, so they are computed
once per shape and device, in float32 with dmfusion's arithmetic
(``jnp.linspace`` as XLA computes it included), and only for the centre
half that :func:`q_sampling` keeps; the batch reads them by broadcast.
The filters and the reflect-pad indices are likewise built once per
device, so a forward copies nothing from the host.

The filters are float32 constants, and the transform runs in float32
whatever the compute dtype: under ``torch.autocast`` the convolutions
would otherwise run in bf16, so :func:`contourlet_decompose` disables
autocast and widens its input.  Everything is plain PyTorch (depthwise
``F.conv2d``, ``index_select``); dmfusion computes it outside any Pallas
kernel too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# 9/7 biorthogonal pyramid filter taps (public filter-bank constants).
_H9 = np.array([0.037828455506995, -0.023849465019380, -0.11062440441842,
                0.37740285561265, 0.85269867900940, 0.37740285561265,
                -0.11062440441842, -0.023849465019380, 0.037828455506995])
_G7 = np.array([-0.064538882628938, -0.040689417609558, 0.41809227322221,
                0.78848561640566, 0.41809227322221, -0.040689417609558,
                -0.064538882628938])

# Diamond/fan DFB analysis filters (5x5), standard contourlet toolbox values.
_H0 = np.array([[0, 0, -1, 0, 0],
                [0, -2, 4, -2, 0],
                [-1, 4, 28, 4, -1],
                [0, -2, 4, -2, 0],
                [0, 0, -1, 0, 0]], dtype=np.float64) / 32.0
_H1 = np.array([[0, 0, 0, 0, 0],
                [0, -1, 0, 0, 0],
                [-1, 4, -1, 0, 0],
                [0, -1, 0, 0, 0],
                [0, 0, 0, 0, 0]], dtype=np.float64) / 4.0

# The 2-D filters by name: the pyramid's analysis (9x9) and synthesis
# (7x7) outer products and the two fan filters.
_FILTERS = {"lp_h": np.outer(_H9, _H9), "lp_g": np.outer(_G7, _G7),
            "h0": _H0, "h1": _H1}

_Q_MATS = {
    ("q0", "down"): np.array([[1.0, -1.0, 0.0], [1.0, 1.0, 0.0]]),
    ("q1", "down"): np.array([[1.0, 1.0, 0.0], [-1.0, 1.0, 0.0]]),
    ("q0", "up"): np.array([[0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]]),
    ("q1", "up"): np.array([[0.5, -0.5, 0.0], [0.5, 0.5, 0.0]]),
}


@functools.lru_cache(maxsize=64)
def _filter(name: str, channels: int, device: torch.device) -> torch.Tensor:
    """The depthwise weight (C, 1, kh, kw) of filter ``name``, float32, on
    ``device``: built once, so a forward copies nothing to the card."""
    k = torch.from_numpy(np.asarray(_FILTERS[name], np.float32))
    return k.expand(channels, 1, *k.shape).contiguous().to(device)


def _depthwise_conv(x: torch.Tensor, name: str,
                    stride: int = 1) -> torch.Tensor:
    """NCHW depthwise cross-correlation with filter ``name`` on every
    channel, VALID padding."""
    c = x.shape[1]
    return F.conv2d(x, _filter(name, c, x.device), stride=stride, groups=c)


@functools.lru_cache(maxsize=256)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """The source index of each position of ``np.pad(..., pad,
    mode="reflect")`` along an axis of length ``n``: reflection without
    repeating the edge, periodic with period ``2 (n - 1)``, so pads longer
    than the axis reflect again as numpy's do."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return torch.zeros(len(i), dtype=torch.int64, device=device)
    period = 2 * (n - 1)
    m = np.remainder(i, period)
    return torch.from_numpy(np.where(m < n, m, period - m)).to(device)


def _reflect_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """numpy ``"reflect"`` padding of the last two axes by ``ph`` rows and
    ``pw`` columns on each side."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, _reflect_index(h, ph, x.device))
    return x.index_select(-1, _reflect_index(w, pw, x.device))


def lp_dec(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Laplacian pyramid analysis: (B, C, H, W) -> (low (B, C, ceil(H/2),
    ceil(W/2)), high (B, C, H, W)).  The decimated lowband is the smoothing
    conv at stride 2: the outputs ``[::2, ::2]`` of the stride-1 conv."""
    # Pads of half the 9-tap and the 7-tap filter keep the size.
    low = _depthwise_conv(_reflect_pad(img, 4, 4), "lp_h", stride=2)
    up = torch.zeros_like(img)
    up[:, :, ::2, ::2] = low
    smooth = _depthwise_conv(_reflect_pad(up, 3, 3), "lp_g")
    return low, img - smooth


def _linspace32(n: int) -> np.ndarray:
    """``jnp.linspace(-1.0, 1.0, n)`` as XLA computes it in float32:
    ``start * (1 - step) + stop * step`` with ``step = iota * (1 / (n -
    1))`` (XLA turns the division by a constant into a product by its
    reciprocal), and the last point exactly ``stop``."""
    if n == 1:
        return np.array([-1.0], np.float32)
    step = np.arange(n - 1, dtype=np.float32) * (np.float32(1.0)
                                                 / np.float32(n - 1))
    out = np.float32(-1.0) * (np.float32(1.0) - step) + np.float32(1.0) * step
    return np.append(out, np.float32(1.0)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _sample_plan(h: int, w: int, q: tuple[str, str], rows: tuple[int, int],
                 cols: tuple[int, int], device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows ``[r0, r1)`` and columns ``[c0, c1)`` of the affine resample of
    an (h, w) image by ``_Q_MATS[q]``: for each of these output pixels, the
    flat source index of its four bilinear neighbours, in
    ``map_coordinates``' order (row low, col low), (low, high), (high,
    low), (high, high), and their weights (row weight x column weight,
    float32), 0 for a neighbour outside the image.  Returns (4, N) int64
    and (4, N) float32."""
    theta = _Q_MATS[q].astype(np.float32)
    ys, xs = _linspace32(h), _linspace32(w)
    yn, xn = np.meshgrid(ys[rows[0]:rows[1]], xs[cols[0]:cols[1]],
                         indexing="ij")
    (a, b, tx), (c, d, ty) = theta
    x_s = a * xn + b * yn + tx
    y_s = c * xn + d * yn + ty
    col = (x_s + np.float32(1.0)) * np.float32(w - 1) / np.float32(2.0)
    row = (y_s + np.float32(1.0)) * np.float32(h - 1) / np.float32(2.0)

    def nodes(coord, size):
        lower = np.floor(coord)
        upper_w = (coord - lower).astype(np.float32)
        lower_w = (np.float32(1.0) - upper_w).astype(np.float32)
        index = lower.astype(np.int64)
        return [(index + k, wt, (index + k >= 0) & (index + k < size))
                for k, wt in ((0, lower_w), (1, upper_w))]

    idx, wts = [], []
    for ri, rw, rv in nodes(row, h):
        for ci, cw, cv in nodes(col, w):
            valid = rv & cv
            idx.append(np.where(valid, np.clip(ri, 0, h - 1) * w
                                + np.clip(ci, 0, w - 1), 0).ravel())
            wts.append(np.where(valid, rw * cw, np.float32(0.0)).astype(
                np.float32).ravel())
    return (torch.from_numpy(np.stack(idx)).to(device),
            torch.from_numpy(np.stack(wts)).to(device))


def _grid_sample_affine(img: torch.Tensor, q: tuple[str, str],
                        rows: tuple[int, int], cols: tuple[int, int]
                        ) -> torch.Tensor:
    """Rows ``[r0, r1)`` and columns ``[c0, c1)`` of torch's
    ``affine_grid`` + ``grid_sample`` (align_corners=True, zero padding) of
    ``img`` by ``_Q_MATS[q]``, as dmfusion's ``map_coordinates`` computes
    it: (B, C, h, w) -> (B, C, r1 - r0, c1 - c0)."""
    b, c, h, w = img.shape
    idx, wts = _sample_plan(h, w, q, rows, cols, img.device)
    flat = img.reshape(b, c, h * w)
    out = flat.index_select(2, idx[0]) * wts[0]
    for k in range(1, 4):
        out = out + flat.index_select(2, idx[k]) * wts[k]
    return out.reshape(b, c, rows[1] - rows[0], cols[1] - cols[0])


def q_sampling(img: torch.Tensor, q_mode: str = "q0",
               op_mode: str = "down") -> torch.Tensor:
    """Quincunx resampling (reference dataset.py:73-96): reflect-pad to
    double size, affine resample by the quincunx lattice matrix, keep the
    centre half (only it is resampled)."""
    _, _, h, w = img.shape
    img = _reflect_pad(img, h // 2, w // 2)
    hh, ww = img.shape[-2:]
    return _grid_sample_affine(img, (q_mode, op_mode),
                               (hh // 4, 3 * hh // 4), (ww // 4, 3 * ww // 4))


def _fan(x: torch.Tensor, name: str) -> torch.Tensor:
    return _depthwise_conv(_reflect_pad(x, 2, 2), name)


def dfb_dec(img: torch.Tensor) -> torch.Tensor:
    """Two-level directional filter bank -> 4 subbands stacked on channels
    (band major), centre-cropped to half size (reference
    dataset.py:98-115)."""
    _, _, h, w = img.shape
    y0 = q_sampling(_fan(img, "h0"), "q0", "down")
    y1 = q_sampling(_fan(img, "h1"), "q0", "down")
    out = torch.cat([q_sampling(_fan(y, k), "q1", "down")
                     for y in (y0, y1) for k in ("h0", "h1")], dim=1)
    return out[:, :, h // 4: 3 * h // 4, w // 4: 3 * w // 4]


def contourlet_decompose(img: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> (lowband (B, C, H/2, W/2), subbands (B, 4C, H/2,
    W/2)), float32, with autocast off."""
    with torch.autocast(img.device.type, enabled=False):
        low, high = lp_dec(img.float())
        return low, dfb_dec(high)


def contourlet_pyramid(img: torch.Tensor, levels: int = 3
                       ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Repeated decomposition of the lowband (the reference's dataset_CT
    applies 3 levels to PAN, train/dataset.py:306-309)."""
    lows, subs = [], []
    x = img
    for _ in range(levels):
        low, sub = contourlet_decompose(x)
        lows.append(low)
        subs.append(sub)
        x = low
    return lows, subs
