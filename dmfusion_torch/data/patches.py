"""Batched patch-window extraction from device-resident scenes.

Port of ``dmfusion/data/patches.py``: plain torch, NHWC, the same layout
and the same semantics — including ``jax.lax.dynamic_slice``'s clamping
of each window start so the window fits the scene.  These are the plain
gathers; :mod:`dmfusion_torch.ops.gather` holds the CUDA kernel that
serving uses on the card, held bit-equal to them.
"""

from __future__ import annotations

import numpy as np
import torch

from dmfusion_torch.ops.gather import gather_windows_ref


def gather_windows(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                   size: int) -> torch.Tensor:
    """(H', W', C), (B,), (B,) -> (B, size, size, C) batched window gather."""
    h, w, c = img.shape
    out = gather_windows_ref(img.reshape(h, w * c), xs, ys, size, c)
    return out.reshape(xs.shape[0], size, size, c)


def ids_to_xy(ids: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    return ids // width, ids % width


def gather_dual(ms: torch.Tensor, pan: torch.Tensor, ids: torch.Tensor,
                width: int, patch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Paired MS/PAN windows for flat anchor ids: the PAN anchor is 4x the
    MS anchor and the PAN window edge is ``4 * patch`` (reference
    train/dataset.py:168-185).  Returns ``(B, ps, ps, C)`` and
    ``(B, 4ps, 4ps, 1)``."""
    x, y = ids_to_xy(ids, width)
    ms_p = gather_windows(ms, x, y, patch)
    pan3 = pan[..., None] if pan.ndim == 2 else pan
    pan_p = gather_windows(pan3, 4 * x, 4 * y, 4 * patch)
    return ms_p, pan_p


def gather_tri(ms: torch.Tensor, pan: torch.Tensor, mspan: torch.Tensor,
               ids: torch.Tensor, width: int, patch: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MS window + PAN window + IHS-fused MSPAN window; the MSPAN stream is
    at PAN geometry (reference dataset_tri, train/dataset.py:248-282).
    Returns ``(B, ps, ps, C)``, ``(B, 4ps, 4ps, 1)`` and ``(B, 4ps, 4ps,
    1)``."""
    x, y = ids_to_xy(ids, width)
    ms_p = gather_windows(ms, x, y, patch)
    pan3 = pan[..., None] if pan.ndim == 2 else pan
    mspan3 = mspan[..., None] if mspan.ndim == 2 else mspan
    pan_p = gather_windows(pan3, 4 * x, 4 * y, 4 * patch)
    mspan_p = gather_windows(mspan3, 4 * x, 4 * y, 4 * patch)
    return ms_p, pan_p, mspan_p


def gather_quad(ms: torch.Tensor, pan_ms: torch.Tensor, ms_gan: torch.Tensor,
                pan_gan: torch.Tensor, ids: torch.Tensor, width: int,
                patch: int) -> tuple[torch.Tensor, ...]:
    """Four aligned ``(B, ps, ps, C)`` windows at the MS anchor, one per
    MS-geometry stream of the two-stage (DQTL) classifier: MS,
    ``pan2ms(PAN)``, the GAN's fake PAN (``msgan.npy``) and fake MS
    (``pangan.npy``) (reference dataset_qua_dqtl,
    train/dataset.py:191-224)."""
    x, y = ids_to_xy(ids, width)
    return tuple(gather_windows(img, x, y, patch)
                 for img in (ms, pan_ms, ms_gan, pan_gan))


def gather_one(img: torch.Tensor, ids: torch.Tensor, width: int,
               patch: int) -> torch.Tensor:
    """Single-modality windows (reference dataset_one)."""
    x, y = ids_to_xy(ids, width)
    img3 = img[..., None] if img.ndim == 2 else img
    return gather_windows(img3, x, y, patch)


def batched_ids_np(ids, batch: int, fill_value: int = 0
                   ) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad ``ids`` to a multiple of ``batch``: returns ``(padded (steps,
    batch), mask (steps, batch), n)``; the mask marks real entries."""
    ids = np.asarray(ids)
    n = ids.shape[0]
    steps = -(-n // batch)
    padded = np.full((steps * batch,), fill_value, dtype=ids.dtype)
    padded[:n] = ids
    mask = (np.arange(steps * batch) < n).reshape(steps, batch)
    return padded.reshape(steps, batch), mask, n


def batched_ids(ids, batch: int, fill_value: int = 0,
                device: torch.device | str = "cpu"
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`batched_ids_np`, moved to ``device`` once."""
    padded, mask, n = batched_ids_np(ids, batch, fill_value)
    return (torch.from_numpy(padded).to(device),
            torch.from_numpy(mask).to(device), n)
