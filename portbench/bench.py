"""``BENCHMARK.json`` and the files it names, found by name.

* a workload's configuration: ``portbench/configs/<config>.json``;
* its traffic mix: ``portbench/traffic/<traffic>.json``, whose ``entry``
  names the driver ``portbench/entries/<entry>.py``;
* the limits of its check: ``portbench/limits/<workload>.json``;
* every metric: a reader ``portbench/metrics/<metric>.py`` with
  ``read(run) -> float | None``.

A cell is added by adding these files and entries; no code names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Any

PACKAGE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Benchmark:
    def __init__(self, root: str, package: str = PACKAGE):
        self.root = root
        self.package = package
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                out = load_json(os.path.join(self.root, c["file"]))
                out["name"] = name
                return out
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.package, "traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return load_json(os.path.join(self.package, "limits",
                                      f"{workload}.json"))

    def end_to_end(self, workload: str) -> list[dict]:
        """The end-to-end metrics ``workload`` reports."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics ``workload`` reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str):
        path = os.path.join(self.package, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def entry(name: str):
    """The driver module of a traffic mix's ``entry``."""
    return importlib.import_module(f"portbench.entries.{name}")
