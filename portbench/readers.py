"""Helpers the metric readers under ``portbench/metrics/`` share.

A reader is ``read(run) -> float | None``: ``None`` where the run holds
nothing for it to read (no trace, no launch of its kernel), so that the
harness leaves the metric out of the line; never 0 in place of a share.

Nothing here names a model or a cell: operation counts come from the
cell's traffic entry, which counts the reference call its check makes,
and byte counts from the configuration's reference module and the
inputs the traced stretch sent.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import bytecount, flops, peaks, system
from portbench.bench import entry


def idle_pct(run) -> float | None:
    """Share of the traced window in which nothing ran on the card."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def unit_flops(run) -> int:
    """The reference's operations for one unit of the window's work (a
    request, a map, a training step), as the cell's entry counts them."""
    return entry(run.traffic["entry"]).unit_flops(run)


def mfu_pct(run, unit: str) -> float | None:
    """The window's model operations per second, as a share of the card's
    peak in the configuration's compute dtype: the operations of one
    ``unit`` (requests or steps) times their count, over the window."""
    n = run.units.get(unit)
    if not n or not run.window_s:
        return None
    rate = unit_flops(run) * n / run.window_s
    return 100.0 * rate / peaks.FLOP_PER_S[run.config["compute_dtype"]]


def roofline_pct(run, fragment: str, least_bytes) -> float | None:
    """A memory-bound kernel's share of its roofline over the trace: the
    bytes its launches must move (``least_bytes(launches)``) at the card's
    peak bandwidth, over the device time they took."""
    if run.trace is None:
        return None
    seconds, launches = run.trace.matching(fragment)
    if not launches or seconds <= 0:
        return None
    moved = least_bytes(launches)
    if not moved:
        return None
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / seconds


def gather_bytes(run) -> int | None:
    """Least bytes of the traced stretch's window gathers: one family call
    of every stream the reference's ``windows`` gathers, a traced request
    each (the ids its entry kept)."""
    calls = getattr(run.state, "traced_ids", None)
    if not calls:
        return None
    ref, s = system.reference(run.config), run.state.scene
    dev = s.streams[0].device
    return bytecount.gather(
        lambda *a: ref.windows(*a, s.width, s.patch),
        [tuple(t.shape) for t in s.streams],
        [torch.from_numpy(np.asarray(a)).to(dev) for a in calls],
        bytecount.DTYPE_BYTES[run.config["scene_dtype"]])


def pool_bytes(run) -> int:
    """Least bytes of one phase pool of a scene's map: the reference's
    full-resolution features (their shape, on meta tensors) to the map."""
    ref, s = system.reference(run.config), run.state.scene
    p = flops.meta_params(system.param_spec(run.config))
    f = ref.features(p, *(flops.meta_like(t) for t in s.streams))
    return bytecount.phase_pool(f.shape[:2], (s.height, s.width),
                                int(f.shape[2]), run.config["compute_dtype"])


def host_copy_ms(run) -> float | None:
    """Device milliseconds of host-card copies a traced request."""
    t, n = run.trace, run.traced_units.get("requests")
    if t is None or not n:
        return None
    sec = sum(v[0] for k, v in t.ops().items()
              if k.startswith("Memcpy") and ("HtoD" in k or "DtoH" in k))
    return 1e3 * sec / n


def op_share_pct(run, key: str) -> float | None:
    """Share of the traced device time (every kernel, copy and set) spent
    under the host operator ``key`` (``key_averages()``: its device time,
    children included, in microseconds)."""
    t = run.trace
    if t is None or t.averages is None:
        return None
    total = sum(v[0] for v in t.ops().values())
    under = sum(e.device_time_total for e in t.averages if e.key == key)
    if total <= 0 or under <= 0:
        return None
    return 100.0 * under / 1e6 / total
