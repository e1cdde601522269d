"""Readers' helpers for the spans the program records itself
(``dmfusion_torch/trace.py``): ranges on the profiler's clock, kept by
``portbench/trace.py::Trace`` beside the harness's own spans.

Three kinds of number come from them, none by overlap in time (the card
runs behind the host):

* device time by launch: ``key_averages()`` gives each host-side span the
  device time of the torch operators' kernels and copies launched inside
  it;
* a launch span's kernel time: a kernel launched through ``ctypes`` is no
  torch operator's, and the profiler links it to no host-side entry (the
  span's entry holds its ``cudaLaunchKernel`` call alone, about 22 us a
  span on an H100's host whatever the kernel's length).  The span's
  ``gpu_user_annotation`` mirror, the other ``key_averages()`` entry of
  the same name, is the extent on the card of the work launched inside
  it: with one launch a span, that kernel's time;
* idle card time inside a span: the span's host interval less the card's
  busy intervals.

Every helper returns ``None`` where the trace holds none of its spans.
"""

from __future__ import annotations

from torch.autograd import DeviceType

from portbench import peaks


def intervals(trace, names) -> list[tuple[float, float]]:
    """The union of the spans called one of ``names`` inside the window,
    sorted (trace microseconds)."""
    ivs = sorted((max(s, trace.t0), min(e, trace.t1))
                 for n, s, e in trace.spans if n in names
                 and s < trace.t1 and e > trace.t0)
    merged: list[list[float]] = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def count(trace, name: str) -> int:
    """The spans called ``name`` that start inside the window."""
    return sum(1 for n, s, _ in trace.spans
               if n == name and trace.t0 <= s < trace.t1)


def _annotation_s(trace, name: str, host: bool) -> float | None:
    if trace.averages is None:
        return None
    us = sum(e.device_time_total for e in trace.averages
             if e.key == name and e.is_user_annotation
             and (e.device_type == DeviceType.CPU) == host)
    return us / 1e6 if us > 0 else None


def device_s(trace, name: str) -> float | None:
    """Device seconds of the torch operators' work launched inside the
    host-side spans called ``name``, nested spans' included."""
    return _annotation_s(trace, name, host=True)


def launch_s(trace, name: str) -> float | None:
    """Device seconds of the spans called ``name`` on the card (their
    mirrors' extents): one kernel's time a span that launches one."""
    return _annotation_s(trace, name, host=False)


def idle_s(trace, names) -> float | None:
    """Seconds inside the spans called one of ``names`` in which nothing
    ran on the card."""
    spans = intervals(trace, names)
    if not spans:
        return None
    busy = trace.busy_intervals()
    idle, j = 0.0, 0
    for s, e in spans:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return idle / 1e6


def idle_ms_per(run, names, unit: str) -> float | None:
    """Idle card milliseconds inside the spans ``names``, per traced
    ``unit`` (``requests``, ``steps``)."""
    n = run.traced_units.get(unit)
    if run.trace is None or not n:
        return None
    sec = idle_s(run.trace, names)
    return None if sec is None else 1e3 * sec / n


def device_ms_per(run, name: str, unit: str) -> float | None:
    """Device milliseconds launched inside the spans ``name``, per traced
    ``unit``."""
    n = run.traced_units.get(unit)
    if run.trace is None or not n or not count(run.trace, name):
        return None
    sec = device_s(run.trace, name)
    return None if sec is None else 1e3 * sec / n


def roofline_pct(run, name: str, least_bytes) -> float | None:
    """A memory-bound kernel's share of its roofline, found by its launch
    span ``name``: the bytes its launches must move (``least_bytes(n)``,
    ``n`` the spans in the window) at the card's peak bandwidth, over the
    device time of the kernels launched inside them."""
    if run.trace is None:
        return None
    n = count(run.trace, name)
    sec = launch_s(run.trace, name) if n else None
    if sec is None:
        return None
    moved = least_bytes(n)
    if not moved:
        return None
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / sec
