"""``BENCHMARK.json`` keeps the contract's shape, and everything it names
is a file of its own that the harness finds by name."""

import json
import os
import re
import shutil
import sys

import pytest
import torch

from portbench import harness
from portbench.bench import Benchmark, entry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in spec["paths"])
    assert len(spec["command"]) <= 32


def test_names_and_units(spec):
    names = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
             + [w["config"] for w in spec["workloads"]]
             + [w["traffic"] for w in spec["workloads"]]
             + [k for c in spec["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in SOURCES for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in spec["end_to_end"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in spec[group]]
        assert len(seen) == len(set(seen)), group
    for text in ([c["why"] for c in spec["configs"]]
                 + [w["why"] for w in spec["workloads"]]
                 + [m["layer"] for m in spec["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_its_layers_move(root, spec):
    bench = Benchmark(root)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for w in spec["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.per_layer(w["name"])
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (m["name"], w["name"])
    for m in spec["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in bench.end_to_end(w)}


def test_every_named_file_exists(root, spec):
    bench = Benchmark(root)
    for c in spec["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = bench.config(c["name"])
        assert cfg["source"].startswith(c["source"])
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        entry(bench.traffic(w["traffic"])["entry"])
        assert bench.limits(w["name"])["numbers"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


STUB_REFERENCE = """\"\"\"A stand-in reference module: gmfnet's mathematics under
another name, as a new configuration would bring its own.\"\"\"
from portbench.reference.gmfnet import (OUT_BIAS, anchor_logits, logits,
                                        param_spec, windows)
"""


def test_a_cell_added_as_data_runs_with_no_code_edit(root, tmp_path,
                                                     small_over,
                                                     monkeypatch):
    # A new configuration with its own reference module, a new traffic mix
    # (raster requests of 128 anchors), its limits and its workload entry:
    # new files only, in a copy of the benchmark's data files.
    import portbench.reference

    pkg = tmp_path / "portbench"
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(root, "portbench", sub), pkg / sub)
    refs = tmp_path / "refs"
    refs.mkdir()
    (refs / "stubnet.py").write_text(STUB_REFERENCE)
    monkeypatch.setattr(portbench.reference, "__path__",
                        list(portbench.reference.__path__) + [str(refs)])
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for c in spec["configs"]:
        c["file"] = os.path.join(root, c["file"])
    config = json.load(open(spec["configs"][0]["file"]))
    config.update(reference="stubnet", model_width=16)
    json.dump(config, open(tmp_path / "stubnet-w16-p16.json", "w"))
    spec["configs"].append({"name": "stubnet-w16-p16", "source": "stub",
                            "file": str(tmp_path / "stubnet-w16-p16.json"),
                            "reduced": [], "why": "a stand-in"})
    traffic = json.load(open(pkg / "traffic" / "serve-b4096.json"))
    traffic.update(anchors_per_request=128, draw="raster", traced_units=3)
    json.dump(traffic, open(pkg / "traffic" / "serve-raster-b128.json", "w"))
    shutil.copy(pkg / "limits" / "gmfnet.serve-b4096.json",
                pkg / "limits" / "stubnet.serve-raster-b128.json")
    cell = "stubnet.serve-raster-b128"
    spec["workloads"].append({"name": cell, "config": "stubnet-w16-p16",
                              "traffic": "serve-raster-b128", "chips": 1,
                              "why": "a dummy cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "gmfnet.serve-b4096" in m.get("workloads", []):
            m["workloads"].append(cell)
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    bench = Benchmark(str(tmp_path), str(pkg))
    over = {"config": dict(small_over["gmfnet.serve-b4096"]["config"],
                           model_width=16)}
    try:
        run, checks = harness.run_cell(bench, cell, 5, 0.2, False,
                                       torch.device("cpu"), 0.0, over)
        assert run.units["pixels"] == 128 * run.attempted
        got = harness.metrics(bench, run, False)
        assert set(got) == {"pixels_per_s", "request_p95_ms", "setup_s"}
        assert harness.judge(run, checks)[0]
        run, _ = harness.run_cell(bench, cell, 6, 0.2, True,
                                  torch.device("cpu"), 0.0, over)
        got = harness.metrics(bench, run, True)
        # Every per-layer metric of the cell reads or stays silent; on the
        # CPU the trace holds no kernel, so the roofline stays silent.
        want = {m["name"] for m in bench.per_layer(cell)}
        assert want >= set(got) >= {"idle_pct.serve", "mfu_pct.serve"}
        assert "gather_windows_roofline" not in got
        assert len(run.state.traced_ids) == 3
        from portbench import readers
        assert readers.gather_bytes(run) > 0
    finally:
        sys.modules.pop("portbench.reference.stubnet", None)
