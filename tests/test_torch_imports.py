"""The port stands alone: importing it pulls in no JAX, flax, optax or
``dmfusion`` module, and no port source names them."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "dmfusion_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dmfusion'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ``dmfusion\b`` does not match ``dmfusion_torch``: ``_`` is a word character.
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|dmfusion)\b",
                        re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")))
def test_source_names_no_jax_or_dmfusion(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text())


def test_chip_smoke_names_no_jax_or_dmfusion():
    assert not _FORBIDDEN.findall((ROOT / "chip_smoke.py").read_text())


@pytest.mark.parametrize("module", [
    "dmfusion_torch", "dmfusion_torch.infer",
    "dmfusion_torch.tools.strip_gather_bench",
    "dmfusion_torch.tools.conv_kernel_probe",
    "dmfusion_torch.tools.pool_probe"])
def test_entry_point_alone_imports_without_jax(module):
    """Each entry point, imported alone in a fresh interpreter."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'dmfusion')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
