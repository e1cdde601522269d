"""The arithmetic of the end-to-end numbers: rates over a whole window and
percentiles over every request in it.

A window is ``[start, end]`` on the host clock, where ``end`` is the
moment the last unit of work started in it has come back to the host; a
rate is all the work of the window over all of its seconds, whatever
stalls happened inside.  A percentile is taken over every request
completed in the window, by the inclusive method of
``statistics.quantiles``.
"""

from __future__ import annotations

import statistics
from typing import Sequence


def rate(units: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return units / seconds


def percentile(values: Sequence[float], pct: int) -> float:
    """The ``pct``-th percentile (1..99) of ``values``."""
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]
