"""The readers of the program's own spans (``portbench/program_spans.py``
and the five metrics that use it), on a hand-made trace, and a CPU traced
run of a small serve cell whose idle gaps the program's spans name."""

import copy
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, peaks, program_spans
from portbench.bench import Benchmark
from portbench.trace import WINDOW, Trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _avg(key, device_type, device_us):
    return SimpleNamespace(key=key, is_user_annotation=True,
                           device_type=device_type,
                           device_time_total=device_us)


#: Two requests of a serve cell: the harness's span around the program's;
#: B1, the model's kernels and the labels' copy on the card, behind the
#: host; each program span's ``gpu_user_annotation`` mirror.
SERVE = [
    _ev("user_annotation", WINDOW, 1000.0, 1000.0),
    _ev("user_annotation", "serve.predict_ids", 1000.0, 450.0),
    _ev("user_annotation", "predict_ids", 1005.0, 440.0),
    _ev("user_annotation", "predict_ids.ids_to_card", 1006.0, 10.0),
    _ev("user_annotation", "predict_ids.gather", 1020.0, 20.0),
    _ev("user_annotation", "b1.launch", 1025.0, 5.0),
    _ev("user_annotation", "model.forward", 1045.0, 100.0),
    _ev("user_annotation", "predict_ids.labels_to_host", 1150.0, 290.0),
    _ev("user_annotation", "serve.predict_ids", 1500.0, 450.0),
    _ev("user_annotation", "predict_ids", 1505.0, 440.0),
    _ev("user_annotation", "predict_ids.ids_to_card", 1506.0, 10.0),
    _ev("user_annotation", "predict_ids.gather", 1520.0, 20.0),
    _ev("user_annotation", "b1.launch", 1525.0, 5.0),
    _ev("user_annotation", "model.forward", 1545.0, 100.0),
    _ev("user_annotation", "predict_ids.labels_to_host", 1650.0, 290.0),
    _ev("gpu_user_annotation", "b1.launch", 1030.0, 20.0),
    _ev("gpu_user_annotation", "model.forward", 1060.0, 300.0),
    _ev("gpu_user_annotation", "b1.launch", 1530.0, 20.0),
    _ev("gpu_user_annotation", "model.forward", 1560.0, 300.0),
    _ev("kernel", "gather_family_kernel<16>", 1030.0, 20.0),
    _ev("kernel", "conv", 1060.0, 300.0),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1400.0, 10.0),
    _ev("kernel", "gather_family_kernel<16>", 1530.0, 20.0),
    _ev("kernel", "conv", 1560.0, 300.0),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1900.0, 10.0),
]

#: key_averages(): the host-side entries (the torch operators' device
#: time by launch, nested spans' included; a ctypes launch's kernel is not
#: among them) and the mirrors on the card (a span's extent there).
SERVE_AVERAGES = [
    _avg("b1.launch", DeviceType.CPU, 44.0),
    _avg("b1.launch", DeviceType.CUDA, 40.0),
    _avg("model.forward", DeviceType.CPU, 600.0),
    _avg("model.forward", DeviceType.CUDA, 600.0 * 7),
    _avg("predict_ids", DeviceType.CPU, 656.0),
    SimpleNamespace(key="aten::copy_", is_user_annotation=False,
                    device_type=DeviceType.CPU, device_time_total=20.0),
]


def _run(events, averages, units, **more):
    return SimpleNamespace(trace=Trace(events, averages), traced_units=units,
                           **more)


@pytest.fixture(scope="module")
def bench(root):
    return Benchmark(root)


def test_mirrors_change_no_busy_time():
    bare = [e for e in SERVE if e["cat"] != "gpu_user_annotation"]
    assert Trace(SERVE).busy_s == Trace(bare).busy_s == pytest.approx(
        660e-6)
    assert Trace(SERVE).gaps() == Trace(bare).gaps()


def test_span_helpers():
    t = Trace(SERVE, SERVE_AVERAGES)
    assert program_spans.count(t, "b1.launch") == 2
    assert program_spans.device_s(t, "model.forward") == pytest.approx(
        600e-6)
    assert program_spans.launch_s(t, "b1.launch") == pytest.approx(40e-6)
    assert program_spans.device_s(t, "train.step") is None
    assert program_spans.launch_s(t, "train.step") is None
    # predict_ids: 1005-1445 and 1505-1945; busy inside 1030-1050,
    # 1060-1360, 1400-1410, 1530-1550, 1560-1860, 1900-1910.
    assert program_spans.idle_s(t, ("predict_ids",)) == pytest.approx(
        (440 - 330) * 2e-6)
    # A nested span adds nothing to the union.
    assert program_spans.idle_s(t, ("predict_ids", "model.forward")) == (
        program_spans.idle_s(t, ("predict_ids",)))
    assert program_spans.idle_s(t, ("class_map",)) is None


@pytest.mark.parametrize("mirrors", [True, False])
def test_serve_readers(bench, monkeypatch, mirrors):
    # The mirrors in the event list change no reader.
    import portbench.readers
    monkeypatch.setattr(portbench.readers, "gather_bytes",
                        lambda run: 60_300_000)
    events = [e for e in SERVE
              if mirrors or e["cat"] != "gpu_user_annotation"]
    run = _run(events, SERVE_AVERAGES, {"requests": 2, "pixels": 8192})
    share = 100 * 60_300_000 / peaks.HBM_BYTES_PER_S / 40e-6
    assert bench.reader("gather_windows_roofline.span")(run) == (
        pytest.approx(share))
    # B1's name-matched share reads the same kernels by their symbol.
    assert bench.reader("gather_windows_roofline")(run) == pytest.approx(
        share)
    assert bench.reader("model_ms.serve")(run) == pytest.approx(0.3)
    assert bench.reader("entry_idle_ms.serve")(run) == pytest.approx(0.11)


def test_map_and_train_readers(bench, monkeypatch):
    import portbench.readers
    monkeypatch.setattr(portbench.readers, "pool_bytes",
                        lambda run: 542_300_000)
    events = [
        _ev("user_annotation", WINDOW, 0.0, 1000.0),
        _ev("user_annotation", "map.class_map", 0.0, 400.0),
        _ev("user_annotation", "class_map", 2.0, 390.0),
        _ev("user_annotation", "model.forward", 4.0, 380.0),
        _ev("user_annotation", "b2.launch", 50.0, 5.0),
        _ev("gpu_user_annotation", "b2.launch", 200.0, 160.0),
        _ev("kernel", "phase_pool_kernel", 200.0, 160.0),
        _ev("kernel", "conv", 10.0, 190.0),
        _ev("user_annotation", "train.step", 500.0, 200.0),
        _ev("user_annotation", "train.step", 700.0, 250.0),
        _ev("kernel", "conv", 520.0, 400.0),
    ]
    averages = [_avg("b2.launch", DeviceType.CPU, 22.0),
                _avg("b2.launch", DeviceType.CUDA, 160.0),
                _avg("model.forward", DeviceType.CPU, 350.0)]
    run = _run(events, averages, {"requests": 1, "steps": 2})
    assert bench.reader("phase_pool_roofline.span")(run) == pytest.approx(
        100 * 542_300_000 / peaks.HBM_BYTES_PER_S / 160e-6)
    assert bench.reader("model_ms.serve")(run) == pytest.approx(0.35)
    # class_map 2-392: busy 10-360; train.step 500-950: busy 520-920.
    assert bench.reader("entry_idle_ms.serve")(run) == pytest.approx(0.04)
    assert bench.reader("step_idle_ms.train")(run) == pytest.approx(0.025)


NEW = ("gather_windows_roofline.span", "phase_pool_roofline.span",
       "model_ms.serve", "entry_idle_ms.serve", "step_idle_ms.train")


@pytest.mark.parametrize("metric", NEW)
def test_no_program_span_reads_nothing(bench, monkeypatch, metric):
    # A program without spans (the harness's own alone): None, never 0.
    import portbench.readers
    monkeypatch.setattr(portbench.readers, "gather_bytes", lambda run: 1)
    monkeypatch.setattr(portbench.readers, "pool_bytes", lambda run: 1)
    events = [e for e in SERVE if e["cat"] in ("kernel", "gpu_memcpy")
              or e["name"] == WINDOW or e["name"].startswith("serve.")]
    averages = [a for a in SERVE_AVERAGES if not a.is_user_annotation]
    run = _run(events, averages, {"requests": 2, "steps": 2})
    assert bench.reader(metric)(run) is None
    run.trace = None
    assert bench.reader(metric)(run) is None


def test_cpu_serve_run_names_idle_by_program_spans(bench, small_over):
    """A traced serve run on the CPU: the program's spans nest inside the
    harness's.  With the card taken as busy while the model runs (the CPU
    runs it in line), at least 90 % of the idle time inside the harness's
    ``serve.predict_ids`` falls under a program span."""
    over = copy.deepcopy(small_over["gmfnet.serve-b4096"])
    over["traffic"]["traced_units"] = 3
    run, _ = harness.run_cell(bench, "gmfnet.serve-b4096", 2**31 + 11, 0.1,
                              True, torch.device("cpu"), 0.0, over)
    t = run.trace
    names = {n for n, _, _ in t.spans}
    program = {"predict_ids", "predict_ids.ids_to_card", "predict_ids.gather",
               "model.forward", "predict_ids.labels_to_host"}
    assert names == program | {"serve.predict_ids"}
    assert program_spans.count(t, "predict_ids") == 3
    t.device = sorted((s, e, "model", "kernel") for n, s, e in t.spans
                      if n == "model.forward")
    harness_only = copy.copy(t)
    harness_only.spans = [s for s in t.spans if s[0] == "serve.predict_ids"]
    before = sum(sec for n, sec in harness_only.gaps()
                 if n == "serve.predict_ids")
    named = sum(sec for n, sec in t.gaps() if n in program)
    assert before > 0 and named >= 0.9 * before
    got = harness.metrics(bench, run, True)
    assert got["entry_idle_ms.serve"]["value"] > 0
    assert "model_ms.serve" not in got  # no device time on the CPU
