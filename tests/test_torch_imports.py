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
    "dmfusion_torch", "dmfusion_torch.infer", "dmfusion_torch.cli",
    "dmfusion_torch.export", "dmfusion_torch.models.gmfnet_conv",
    "dmfusion_torch.models.tri_net", "dmfusion_torch.models.resnet18",
    "dmfusion_torch.models.cross_net", "dmfusion_torch.models.vit",
    "dmfusion_torch.models.dqtl", "dmfusion_torch.solvers.twostage",
    "dmfusion_torch.ops.ihs", "dmfusion_torch.ops.image",
    "dmfusion_torch.models.generator", "dmfusion_torch.models.discriminator",
    "dmfusion_torch.train.gan", "dmfusion_torch.report.viz",
    "dmfusion_torch.tools.strip_gather_bench",
    "dmfusion_torch.tools.conv_kernel_probe",
    "dmfusion_torch.tools.pool_probe", "dmfusion_torch.tools.convmap_ab",
    "dmfusion_torch.tools.gather_probe",
    "dmfusion_torch.ops.contourlet", "dmfusion_torch.models.swin",
    "dmfusion_torch.models.swin_dual", "dmfusion_torch.models.ct_lstm",
    "dmfusion_torch.parallel"])
def test_entry_point_alone_imports_without_jax(module):
    """Each entry point, imported alone in a fresh interpreter."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'dmfusion')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_one_rank_has_no_mesh():
    """No process group: a world of 1, and no mesh, as dmfusion drops a
    one-device mesh."""
    from dmfusion_torch.parallel import get_mesh, is_distributed
    assert not is_distributed()
    for cfg in (None, {"mesh": {"data": -1, "model": 1}},
                {"mesh": {"data": 1, "model": 1, "distributed": 0}}):
        assert get_mesh(cfg) is None


def test_cli_without_distributed_starts_no_process_group(tmp_path,
                                                         monkeypatch):
    import torch.distributed

    from dmfusion_torch import cli
    from dmfusion_torch.parallel import is_distributed

    def refuse(*a, **kw):
        raise AssertionError("init_process_group called")

    monkeypatch.delenv("DMFUSION_DISTRIBUTED", raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    solver = cli.main(["--city", "synth64", "--set", "device=cpu",
                       "patch_size=8", "model_width=8", "batchsize=64",
                       "epoch=1", "time=1", "train_rate=0.05",
                       "verify_rate=0.05", "test.index=0", "color.index=0",
                       "nohup=1", f"expo_result={tmp_path}/"])
    assert solver.mesh is None and not is_distributed()
