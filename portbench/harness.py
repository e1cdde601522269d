"""One run of one cell: set-up, the measured window, the traced stretch,
the metrics and the check.

The entry (``portbench/entries/<entry>.py``) drives the program; this
module owns the clock.  A run is:

1. set-up: the entry builds the system from the seed and warms up every
   shape its traffic uses (``setup_s`` runs from process start to here);
2. the window: the entry's units of work (a request, a map, an epoch)
   back to back, each complete on the host before the next starts, until
   ``seconds`` have passed; the window ends when the last unit started in
   it has come back;
3. with ``trace``: a further stretch of the same work under the profiler;
4. the device's peak memory is read, the program's state freed, and the
   entry compares what the window produced with the plain reference.
"""

from __future__ import annotations

import math
import time
from typing import Any

import torch

from portbench import trace as trace_mod
from portbench.bench import Benchmark, entry
from portbench.spans import Spans


class Run:
    """What the readers see: the cell, its files, the clocks, the counts
    and the trace."""

    def __init__(self, bench: Benchmark, workload: str, seed: int,
                 seconds: float, device: torch.device,
                 over: dict | None = None):
        self.workload = bench.workload(workload)
        self.config = bench.config(self.workload["config"])
        self.traffic = bench.traffic(self.workload["traffic"])
        # Small sizes for the CPU tests: replaced keys of the files.
        self.config.update((over or {}).get("config", {}))
        self.traffic.update((over or {}).get("traffic", {}))
        self.limits = bench.limits(workload)
        self.limits.update((over or {}).get("limits", {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.spans = Spans()
        self.setup_s: float | None = None
        self.window_s: float | None = None
        self.units: dict[str, float] = {}
        self.latencies_s: list[float] = []
        self.attempted = 0
        self.failed = 0
        self.trace: trace_mod.Trace | None = None
        self.traced_units: dict[str, float] = {}

    def count(self, units: dict[str, float], into: dict) -> None:
        for k, v in units.items():
            into[k] = into.get(k, 0) + v


def run_cell(bench: Benchmark, workload: str, seed: int, seconds: float,
             traced: bool, device: torch.device, process_start: float,
             over: dict | None = None, window: bool = True
             ) -> tuple[Run, dict]:
    """Run the cell; returns the run and its check's numbers.  Without
    ``window`` (readings of a check that set-up alone feeds) no unit of
    work is timed."""
    run = Run(bench, workload, seed, seconds, device, over)
    driver = entry(run.traffic["entry"])
    run.setup_started = time.perf_counter()
    if device.type == "cuda":
        run.spans.sync = torch.cuda.synchronize
    run.state = state = driver.setup(run)
    run.spans.sync = None
    _sync(device)
    t0 = time.perf_counter()
    run.setup_s = t0 - process_start
    while window:
        out = driver.unit(run, state)
        run.attempted += 1
        run.failed += int(not out["ok"])
        run.count(out["units"], run.units)
        if "latency_s" in out:
            run.latencies_s.append(out["latency_s"])
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    if traced:
        def stretch():
            for _ in range(int(run.traffic["traced_units"])):
                run.count(driver.unit(run, state, timed=False,
                                      traced=True)["units"],
                          run.traced_units)
        run.trace = trace_mod.record(
            stretch, run.spans, lambda: driver.unit(run, state, timed=False))
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    driver.release(run, state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(run, state)
    return run, checks


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def metrics(bench: Benchmark, run: Run, traced: bool) -> dict[str, Any]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each ``{"value", "unit"}``; a reader that finds nothing to
    read leaves its metric out."""
    names = (bench.per_layer(run.workload["name"]) if traced
             else bench.end_to_end(run.workload["name"]))
    out = {}
    for m in names:
        value = bench.reader(m["name"])(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(run: Run, checks: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit."""
    limits = run.limits["numbers"]
    table = {}
    ok = run.attempted > 0 and run.failed == 0
    for name, lim in limits.items():
        value = checks.get(name)
        table[name] = {"value": value, "limit": lim["limit"]}
        if value is None or not math.isfinite(value) or value > lim["limit"]:
            ok = False
    return ok, table
