"""Independent streams of randomness derived from the run's ``--seed``.

Each consumer (the weights, a scene, the traffic, the check's sample) gets
its own 63-bit seed from ``numpy.random.SeedSequence([seed, tag])``, so
adding a consumer changes no other stream.  Any whole number is a valid
``--seed``: it is reduced to 64 bits first.
"""

from __future__ import annotations

import zlib

import numpy as np

_MASK64 = (1 << 64) - 1


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag``'s stream of ``seed``."""
    words = np.random.SeedSequence(
        [int(seed) & _MASK64, zlib.crc32(tag.encode())]).generate_state(
            2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) >> 1


def numpy_rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))
