"""The device trace of a traced stretch of work, reduced to what the
per-layer readers need.

``record(fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activity) inside a harness span called ``WINDOW``, exports the trace as
Chrome JSON to a temporary file under ``TMPDIR`` and reads it back.  The
JSON holds the card's kernels, copies and sets, and the harness's spans
(``user_annotation``), all on the profiler's one clock.  From it:

* ``window_s``: the length of the ``WINDOW`` span;
* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  set ran on the card, inside the window;
* ``ops``: device seconds and launches by operation name;
* ``gaps``: each idle interval inside the window, named by the innermost
  harness span that covers its middle (``host`` where none does).

``averages`` keeps ``key_averages()`` of the profile, for readers that
attribute device time to the host operator that launched it.
"""

from __future__ import annotations

import json
import os
import tempfile

WINDOW = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: list[dict], averages=None):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        win = [e for e in spans if e["name"] == WINDOW]
        if len(win) != 1:
            raise ValueError(f"the trace holds {len(win)} {WINDOW!r} spans")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(
            e["dur"])) for e in spans if e["name"] != WINDOW]
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"], e["cat"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS
            and self.t0 <= float(e["ts"]) < self.t1)
        self.averages = averages

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for s, e, _, _ in self.device:
            e = min(e, self.t1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def ops(self) -> dict[str, list]:
        """``{name: [device seconds, launches]}`` over the window."""
        out: dict[str, list] = {}
        for s, e, name, _ in self.device:
            rec = out.setdefault(name, [0.0, 0])
            rec[0] += (e - s) / 1e6
            rec[1] += 1
        return out

    def matching(self, fragment: str) -> tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        ``fragment``."""
        hits = [v for k, v in self.ops().items() if fragment in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def gaps(self) -> list[tuple[str, float]]:
        """Every idle interval in the window: (host span, seconds)."""
        out, at = [], self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > at:
                out.append((self._span_at((at + s) / 2), (s - at) / 1e6))
            at = max(at, e)
        return out

    def _span_at(self, t: float) -> str:
        best = None
        for name, s, e in self.spans:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return "host" if best is None else best[2]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by the host span it fell in, ``top`` of each."""
        ops = sorted(((k[:120], v[0]) for k, v in self.ops().items()),
                     key=lambda kv: -kv[1])[:top]
        idle: dict[str, float] = {}
        for name, sec in self.gaps():
            idle[name] = idle.get(name, 0.0) + sec
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [list(kv) for kv in ops],
                "idle_gaps": [list(kv) for kv in gaps]}


def record(fn, spans, warmup=None) -> Trace:
    """Run ``fn()`` under the profiler, its spans annotated; the trace.
    ``warmup()`` runs first under a profiler whose record is dropped, so
    that the profiler's own start (CUPTI's buffers, its first callbacks)
    falls outside the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # The CPU tests trace the host alone.
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if card else [])

    def sync():
        if card:
            torch.cuda.synchronize()

    if warmup is not None:
        with profile(activities=activities):
            warmup()
            sync()
    sync()
    spans.annotate = True
    try:
        with profile(activities=activities) as prof:
            with spans.span(WINDOW):
                fn()
                sync()
    finally:
        spans.annotate = False
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, prof.key_averages())
