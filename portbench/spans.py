"""Spans recorded by the harness around its calls into the program.

A span is ``(name, start, end)`` on ``time.perf_counter`` seconds, kept in
memory.  While a profiler records (``annotate``), each span is also a
``torch.profiler.record_function`` range, so the device trace carries the
same spans on its own clock and an idle gap on the card can be laid
against what the host was doing.
"""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self) -> None:
        self.records: list[tuple[str, float, float]] = []
        self.annotate = False
        #: Called at a span's end while set (set-up waits for the card, so
        #: that each phase holds its own device work).
        self.sync = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            import torch.profiler
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        if self.sync is not None:
            self.sync()
        self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        """Seconds spent in spans called ``name``."""
        return sum(t1 - t0 for n, t0, t1 in self.records if n == name)
