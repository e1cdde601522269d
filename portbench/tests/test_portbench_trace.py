"""The reduction of a profiler trace: busy and idle time inside the traced
window, device time by operation, idle gaps named by the host span, and
the readers that take their metrics from it."""

from types import SimpleNamespace

import pytest
import torch

from portbench import bytecount, readers, scenes
from portbench.trace import WINDOW, Trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("user_annotation", WINDOW, 1000.0, 1000.0),
    _ev("user_annotation", "serve.predict_ids", 1000.0, 400.0),
    _ev("user_annotation", "serve.predict_ids", 1500.0, 400.0),
    _ev("kernel", "gather_family_kernel<16>", 1010.0, 40.0),
    _ev("kernel", "conv", 1040.0, 200.0),            # overlaps the gather
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1300.0, 50.0),
    _ev("kernel", "gather_family_kernel<16>", 1510.0, 40.0),
    _ev("kernel", "conv", 1550.0, 250.0),
    _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1850.0, 10.0),
    _ev("kernel", "outside", 2500.0, 10.0),           # after the window
    _ev("cpu_op", "aten::copy_", 1000.0, 10.0),
]


def test_busy_idle_and_ops():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # busy: 1010-1240, 1300-1350, 1510-1800, 1850-1860 = 580 us
    assert t.busy_s == pytest.approx(580e-6)
    ops = t.ops()
    assert ops["conv"] == [pytest.approx(450e-6), 2]
    assert "outside" not in ops
    assert t.matching("gather_family") == (pytest.approx(80e-6), 2)


def test_gaps_named_by_span():
    gaps = Trace(EVENTS).gaps()
    total = sum(s for _, s in gaps)
    assert total == pytest.approx(420e-6)
    by = {}
    for name, sec in gaps:
        by[name] = by.get(name, 0.0) + sec
    # A gap goes whole to the span over its middle: 1000-1010 and
    # 1240-1300 to the first request, 1350-1510 (middle 1430) to the host
    # between requests, 1800-1850 to the second, 1860-2000 to the host.
    assert by["serve.predict_ids"] == pytest.approx(120e-6)
    assert by["host"] == pytest.approx(300e-6)
    b = Trace(EVENTS).breakdown()
    assert b["device_ops"][0][0] == "conv"
    assert b["idle_gaps"][0] == ["host", pytest.approx(300e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_one_window_span_required():
    with pytest.raises(ValueError):
        Trace(EVENTS[1:])


def _meta_scene(height, width, channels, patch):
    m = torch.device("meta")
    return SimpleNamespace(
        height=height, width=width, patch=patch,
        streams=(torch.empty((height + patch - 1, width + patch - 1,
                              channels), device=m),
                 torch.empty((4 * (height + patch) - 1,
                              4 * (width + patch) - 1), device=m)))


def test_readers_on_a_trace():
    run = SimpleNamespace(
        trace=Trace(EVENTS), traced_units={"requests": 2},
        traffic={"anchors_per_request": 4096, "entry": "predict_ids"},
        config={"patch_size": 16, "scene_size": [2001, 2101, 4],
                "scene_dtype": "float32", "model_width": 64,
                "classes": 12, "reference": "gmfnet",
                "compute_dtype": "bfloat16"},
        state=SimpleNamespace(scene=_meta_scene(2001, 2101, 4, 16)),
        units={"requests": 10}, window_s=0.25)
    assert readers.idle_pct(run) == pytest.approx(42.0)
    assert readers.host_copy_ms(run) == pytest.approx(0.03)
    share = readers.roofline_pct(run, "gather_family_kernel",
                                 lambda launches: launches * 1000)
    assert share == pytest.approx(100 * 2000 / 3.35e12 / 80e-6)
    assert readers.roofline_pct(run, "phase_pool_kernel", lambda n: 1) is None
    # No traced ids kept: nothing to count, nothing read.
    assert readers.gather_bytes(run) is None
    mfu = readers.mfu_pct(run, "requests")
    assert mfu == pytest.approx(100 * 180.227072e6 * 4096 * 10 / 0.25
                                / 989e12)
    assert readers.mfu_pct(run, "steps") is None
    run.trace = None
    assert readers.idle_pct(run) is None and readers.host_copy_ms(run) is None


def _brute_gather(scene, calls, patch):
    """Covered scene elements, windows and ids of the calls, by sets."""
    total = 0
    for ids in calls:
        ms, pan = set(), set()
        for a in ids.tolist():
            x, y = divmod(a, scene.width)
            ms.update((x + i, y + j) for i in range(patch)
                      for j in range(patch))
            pan.update((4 * x + i, 4 * y + j) for i in range(4 * patch)
                       for j in range(4 * patch))
        c = scene.ms.shape[2]
        read = len(ms) * c + len(pan)
        written = len(ids) * (patch * patch * c + 16 * patch * patch)
        total += (read + written) * 4 + 4 * len(ids)
    return total


@pytest.mark.parametrize("draw", ["uniform", "raster"])
def test_gather_bytes_count_covered_scene_once(draw):
    from portbench.entries.predict_ids import Draws

    scene = scenes.make([40, 44, 4], 5, 8, torch.float32, 3, "scene0",
                        torch.device("cpu"))
    run = SimpleNamespace(
        seed=7, config={"scene_size": [40, 44, 4], "reference": "gmfnet",
                        "scene_dtype": "float32"},
        traffic={"draw": draw, "anchors_per_request": 64})
    draws = Draws(run, "traffic")
    calls = [draws.next() for _ in range(3)]
    run.state = SimpleNamespace(scene=scene, traced_ids=calls)
    got = readers.gather_bytes(run)
    assert got == _brute_gather(scene, calls, 8)
    windows = 3 * 64 * (8 * 8 * 4 + 32 * 32) * 4
    assert got < 2 * windows + 4 * 3 * 64  # windows overlap on 40 x 44
    if draw == "raster":  # neighbours share most of their windows
        assert got < 1.2 * windows


def test_gather_bytes_follow_the_streams_a_reference_gathers():
    # A three-stream reference: every stream it returns is counted.
    def windows(a, b, c, ids):
        return a[ids], b[ids], c[ids]

    ids = torch.tensor([0, 1, 1, 5])
    got = bytecount.gather(windows, [(8, 3), (8, 2), (8,)], [ids], 2)
    # Distinct rows 0, 1, 5: 9 + 6 + 3 elements read; 12 + 8 + 4 written.
    assert got == (18 + 24) * 2 + 4 * 4


def test_pool_bytes_at_image6():
    run = SimpleNamespace(
        config={"scene_size": [2001, 2101, 4], "patch_size": 16,
                "model_width": 32, "classes": 12,
                "reference": "dense_fusion", "compute_dtype": "bfloat16"},
        state=SimpleNamespace(scene=_meta_scene(2001, 2101, 4, 16)))
    assert readers.pool_bytes(run) == (1008 * 1058 + 1001 * 1051) * 128 * 2


@pytest.mark.parametrize("entry,reference,width,want", [
    ("predict_ids", "gmfnet", 64, 180.227072e6 * 4096),
    ("class_map", "dense_fusion", 32, 1.755857188608e12),
    ("train_epoch", "dense_fusion", 32, None)])
def test_unit_flops_at_cell_sizes(entry, reference, width, want):
    run = SimpleNamespace(
        traffic={"entry": entry, "anchors_per_request": 4096},
        config={"scene_size": [2001, 2101, 4], "model_width": width,
                "classes": 12, "reference": reference, "batchsize": 256},
        state=SimpleNamespace(scene=_meta_scene(2001, 2101, 4, 16)))
    got = readers.unit_flops(run)
    if want is None:
        # A step: the map's features forward and backward (about three
        # times a forward), far more than one batch's head.
        fwd = 1.755857188608e12
        assert 2.5 * fwd < got < 3.5 * fwd
    else:
        assert got == pytest.approx(want, rel=1e-12)
