"""A uniform sample of the outputs a window produced, drawn from the seed.

Reservoir sampling (Vitter's algorithm R): the ``i``-th output replaces a
kept one with probability ``k / (i + 1)``, so after any number of outputs
the ``k`` kept are a uniform sample of all of them, and nothing but those
``k`` is held.
"""

from __future__ import annotations

from typing import Any

from portbench.seeds import numpy_rng


class Reservoir:
    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = numpy_rng(seed, "check-sample")
        self.kept: list[Any] = []
        self.seen = 0

    def offer(self, item: Any) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1
