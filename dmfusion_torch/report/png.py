"""A PNG writer in the standard library (``zlib`` and ``struct``).

Class maps are 8-bit RGB images; this writes them without PIL, which the
machine with the card may lack.  Each row is stored unfiltered (filter
type 0) in one zlib stream, so any PNG reader gives back the exact
pixels.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 array -> PNG bytes (RGB or grey)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected an (H, W, 3) or (H, W) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)  # column 0: filter 0
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str | os.PathLike, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
