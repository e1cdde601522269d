"""Nothing the benchmark runs may bring JAX or the JAX package into its
process.  The check compares whole top-level names: ``dmfusion_torch``
is the program, ``dmfusion`` is the JAX package."""

import subprocess
import sys

import pytest

from portbench.run import forbidden_modules


@pytest.mark.parametrize("names,bad", [
    (["dmfusion_torch", "dmfusion_torch.infer", "portbench.run"], []),
    (["dmfusion", "dmfusion.ops"], ["dmfusion", "dmfusion.ops"]),
    (["jax", "jaxlib.xla_client", "flax.core", "optax"],
     ["flax.core", "jax", "jaxlib.xla_client", "optax"]),
    (["jaxtyping", "flaxen", "dmfusion_extra"], []),
])
def test_top_level_names_compared_whole(names, bad):
    assert forbidden_modules(names) == bad


def test_a_run_loads_no_jax(root, small_over):
    # A whole small run of every cell, in a fresh process, then the check.
    code = f"""
import sys, torch
from portbench import harness
from portbench.bench import Benchmark
from portbench.run import forbidden_modules
b = Benchmark({root!r})
for wl, over in {small_over!r}.items():
    harness.run_cell(b, wl, 1, 0.05, False, torch.device("cpu"), 0.0, over)
import portbench.calibrate, portbench.faults
assert "dmfusion_torch.infer" in sys.modules
bad = forbidden_modules()
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]


def test_no_result_without_the_program(root, tmp_path):
    # A directory with BENCHMARK.json and portbench/ alone: the run fails
    # and prints no result (here: no card, and no program either).
    import shutil
    shutil.copytree(f"{root}/portbench", tmp_path / "portbench")
    shutil.copy(f"{root}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "gmfnet.serve-b4096", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
