"""Tests of the benchmark harness.  They run on the CPU at small sizes;
tests marked ``gpu`` need the card and skip without it (decided inside
the ``card`` fixture, never at import)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def root():
    return ROOT


#: Small sizes of the three cells: the same files, with the scene cut to
#: the port's ``synth64`` city (5 classes), narrower models where the
#: check still tells the control from the program, and for maps more
#: scenes in the sample so that it holds as many pixels as one map of a
#: larger scene.
_SMALL = {"city": "synth64", "scene_size": [64, 72, 4], "classes": 5}
SMALL_OVER = {
    "gmfnet.serve-b4096": {"config": dict(_SMALL, model_width=16),
                           "traffic": {"anchors_per_request": 256}},
    "dense_fusion.map-image6": {"config": dict(_SMALL, model_width=32),
                                "traffic": {"scenes": 8},
                                "limits": {"sample": 8}},
    "dense_fusion.train-b256": {"config": dict(_SMALL, model_width=32,
                                               batchsize=64),
                                "traffic": {"train_anchors": 400}},
}


@pytest.fixture(scope="session")
def small_over():
    return SMALL_OVER


#: Cells that the harness drives but ``BENCHMARK.json`` does not hold yet,
#: each with its workload entry, the limits of its check (read on the
#: card at its own size, PERF.md) and its small sizes.  ``pending_bench``
#: holds them beside the benchmark's own cells.
PENDING = {
    "gmfnet.train-b256": {
        "workload": {
            "name": "gmfnet.train-b256", "config": "gmfnet-w64-p16",
            "traffic": "train-b256", "chips": 1,
            "why": "DualPrograms epochs of 58,875 anchors in batches of "
                   "256, Adam: B1's dual gather a step, gmfnet forward and "
                   "backward with torch's GroupNorm (B5 bypassed under "
                   "autograd); bypasses B2, s2d packing"},
        "limits": {"sample": 0, "numbers": {
            "grad_elem_vs_bf16": {"limit": 3.0, "lower": 1.316,
                                  "upper": 5.30, "upper_from": "control"},
            "delta_gap": {"limit": 0.3, "lower": 0.0721, "upper": 1.0,
                          "upper_from": "state_unchanged"}}},
        "over": {"config": dict(_SMALL, model_width=16, batchsize=64),
                 "traffic": {"train_anchors": 400}},
    },
}


@pytest.fixture(scope="session")
def pending():
    return PENDING


@pytest.fixture(scope="session")
def pending_bench(root, tmp_path_factory):
    """The benchmark with the ``PENDING`` cells added as data: a copy of
    ``BENCHMARK.json`` with their workload entries, and of the traffic
    and limits files with their limits."""
    from portbench.bench import Benchmark

    tmp = tmp_path_factory.mktemp("pending")
    pkg = tmp / "portbench"
    for sub in ("traffic", "limits"):
        shutil.copytree(os.path.join(root, "portbench", sub), pkg / sub)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        c["file"] = os.path.join(root, c["file"])
    for name, cell in PENDING.items():
        spec["workloads"].append(cell["workload"])
        (pkg / "limits" / f"{name}.json").write_text(
            json.dumps(cell["limits"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Benchmark(str(tmp), str(pkg))
