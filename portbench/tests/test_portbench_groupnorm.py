"""groupnorm_ms.serve: the fused GroupNorm's device time a traced request,
read from the program's gn.launch spans' mirrors on the card."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.bench import Benchmark
from portbench.trace import WINDOW, Trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _avg(key, device_type, device_us):
    return SimpleNamespace(key=key, is_user_annotation=True,
                           device_type=device_type,
                           device_time_total=device_us)


#: One request: two B5 launches inside the model's forward; each span's
#: host-side entry holds only its launch call, its mirror the kernel.
EVENTS = [
    _ev("user_annotation", WINDOW, 0.0, 1000.0),
    _ev("user_annotation", "model.forward", 10.0, 300.0),
    _ev("user_annotation", "gn.launch", 20.0, 5.0),
    _ev("user_annotation", "gn.launch", 40.0, 5.0),
    _ev("gpu_user_annotation", "gn.launch", 100.0, 70.0),
    _ev("gpu_user_annotation", "gn.launch", 200.0, 50.0),
    _ev("kernel", "gn_registers", 100.0, 70.0),
    _ev("kernel", "gn_registers", 200.0, 50.0),
]
AVERAGES = [_avg("gn.launch", DeviceType.CPU, 44.0),
            _avg("gn.launch", DeviceType.CUDA, 120.0),
            _avg("model.forward", DeviceType.CPU, 30.0)]


@pytest.fixture(scope="module")
def reader(root):
    return Benchmark(root).reader("groupnorm_ms.serve")


def test_reads_the_mirrors_per_request(reader):
    run = SimpleNamespace(trace=Trace(EVENTS, AVERAGES),
                          traced_units={"requests": 2})
    assert reader(run) == pytest.approx(0.06)


def test_no_span_reads_nothing(reader):
    # A program without B5 (the parent of its PR): None, never 0.
    events = [e for e in EVENTS if e["name"] != "gn.launch"]
    averages = [a for a in AVERAGES if a.key != "gn.launch"]
    run = SimpleNamespace(trace=Trace(events, averages),
                          traced_units={"requests": 2})
    assert reader(run) is None
    run.trace = None
    assert reader(run) is None
