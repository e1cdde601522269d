"""Spans at the program's layer boundaries, on the profiler's clock.

``with span(name):`` is a ``torch.profiler.record_function`` range while a
``torch.profiler`` records, so the range lands in its Chrome trace as a
``user_annotation`` on the clock of the card's kernels and copies, nested
in the spans around it.  When no profiler records it is one shared null
context: a flag check a call.  The profiler holds the spans; nothing here
keeps them.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else
    the shared null context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL
