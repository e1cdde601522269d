"""Serving end to end: a ``.dmx`` written by the JAX package is served by
the port, and the port's predictions match ``dmfusion.infer``'s.

f32 compute on both sides.  Predictions must be equal except on anchors
whose JAX top-2 logit gap is below 1e-3 (convolutions sum in another
order in XLA and oneDNN, so a near-tie may flip).
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.patches import gather_dual as jax_gather_dual
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.export import load_artifact as jax_load_artifact
from dmfusion.export import save_artifact as jax_save_artifact
from dmfusion.infer import ScenePredictor as JaxScenePredictor
from dmfusion.models import build_model as jax_build_model
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.export import load_artifact, save_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.infer import main as infer_main
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params

OVER = {"data_city": "synth64", "patch_size": 8, "model_width": 16,
        "seed": 0, "precision": {"compute_dtype": "float32"}}
GAP = 1e-3
# A .dmx does not record its activation: the caller names it.
RELU = {"schedule": {"activate": "Relu"}}


def _save_dmx(path, over):
    cfg = jax_load_config(overrides=over)
    model = jax_build_model(cfg)
    ins = [jax.random.normal(jax.random.PRNGKey(i), s)
           for i, s in enumerate([(1, 8, 8, 4), (1, 32, 32, 1)])]
    params = model.init(jax.random.PRNGKey(0), *ins)["params"]
    jax_save_artifact(path, cfg, params, platforms=("cpu",))
    return path


@pytest.fixture(scope="module")
def dmx(tmp_path_factory):
    return _save_dmx(tmp_path_factory.mktemp("dmx") / "m.dmx", OVER)


def test_gelu_dmx_served_with_its_activation(tmp_path):
    """A Gelu-trained .dmx, loaded with the activation it was trained
    with, gives dmfusion's logits and predictions; loaded as Relu it
    would not."""
    path = _save_dmx(tmp_path / "gelu.dmx",
                     {**OVER, "schedule": {"activate": "Gelu"}})
    jclf = jax_load_artifact(path)
    rng = np.random.default_rng(8)
    ms = rng.random((64, 8, 8, 4), dtype=np.float32)
    pan = rng.random((64, 32, 32, 1), dtype=np.float32)
    want = np.asarray(jclf.logits(jnp.asarray(ms), jnp.asarray(pan)))
    clf = load_artifact(path, "cpu", overrides={"schedule": {"activate":
                                                             "Gelu"}})
    assert clf.cfg["schedule"]["activate"] == "Gelu"
    got = clf.logits(torch.from_numpy(ms), torch.from_numpy(pan)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    top = np.sort(want, axis=-1)
    clear = (top[:, -1] - top[:, -2]) >= GAP
    preds = clf.predict(torch.from_numpy(ms), torch.from_numpy(pan)).numpy()
    np.testing.assert_array_equal(preds[clear], want.argmax(-1)[clear])
    as_relu = load_artifact(path, "cpu", overrides=RELU).logits(
        torch.from_numpy(ms), torch.from_numpy(pan)).numpy()
    assert not np.allclose(as_relu, want, atol=1e-4, rtol=1e-4)


def test_dmx_without_activation_raises(dmx):
    """A .dmx records no activation, so the loader asks for it instead of
    assuming Relu."""
    with pytest.raises(ValueError, match="schedule.activate"):
        load_artifact(dmx, "cpu")


def _ragged_ids(scene):
    return (np.arange(0, 200, dtype=np.int32) * 7) % scene.num_pixels


def test_served_predictions_match_jax(dmx):
    jclf = jax_load_artifact(dmx)
    jscene = jax_synthetic_scene(jax_load_config(overrides=OVER))
    ids = _ragged_ids(jscene)
    want = JaxScenePredictor(jclf, jscene, bucket=64).predict_ids(ids)

    clf = load_artifact(dmx, "cpu", overrides=RELU)
    assert clf.manifest["model_name"] == "gmfnet"
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    got = ScenePredictor(clf, scene, bucket=64).predict_ids(ids)
    assert got.dtype == np.int32 and got.shape == want.shape

    ms_b, pan_b = jax_gather_dual(jscene.ms, jscene.pan, jnp.asarray(ids),
                                  jscene.width, jscene.patch)
    logits = np.sort(np.asarray(jclf.logits(ms_b, pan_b)), axis=-1)
    near_tie = (logits[:, -1] - logits[:, -2]) < GAP
    np.testing.assert_array_equal(got[~near_tie], want[~near_tie])

    labels = scene.label.reshape(-1)[ids]
    oa_gap = abs((got == labels).mean() - (want == labels).mean())
    assert oa_gap <= near_tie.sum() / ids.shape[0]


def test_dmx_logits_match_jax_program(dmx):
    jclf = jax_load_artifact(dmx)
    rng = np.random.default_rng(4)
    ms = rng.random((5, 8, 8, 4), dtype=np.float32)
    pan = rng.random((5, 32, 32, 1), dtype=np.float32)
    want = np.asarray(jclf.logits(jnp.asarray(ms), jnp.asarray(pan)))
    clf = load_artifact(dmx, "cpu", overrides=RELU)
    got = clf.logits(torch.from_numpy(ms), torch.from_numpy(pan)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_evaluate_and_class_map(dmx):
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    pred = ScenePredictor(load_artifact(dmx, "cpu", overrides=RELU), scene,
                          bucket=512)
    full = pred.class_map()
    assert full.shape == (scene.height, scene.width)
    m = pred.evaluate()
    assert 0.0 <= m["oa"] <= 1.0 and m["confusion"].sum() == m["pixels"]
    labeled = np.flatnonzero(scene.label.reshape(-1)).astype(np.int32)
    x, y = scene.ids_to_xy(labeled)
    np.testing.assert_array_equal(full[x, y], pred.predict_ids(labeled))


@pytest.mark.parametrize("pan", ["s2d", "pyramid"])
def test_own_artifact_round_trip(tmp_path, pan):
    cfg = load_config(overrides={**OVER, "gmfnet_pan": pan,
                                 "schedule": {"activate": "Gelu"}})
    model = init_params(build_model(cfg), torch.Generator().manual_seed(5))
    path = tmp_path / "m.zip"
    manifest = save_artifact(path, cfg, model)
    assert manifest["gmfnet_pan"] == pan and manifest["activate"] == "Gelu"
    clf = load_artifact(path, "cpu")
    rng = np.random.default_rng(6)
    ms = torch.from_numpy(rng.random((3, 8, 8, 4), dtype=np.float32))
    pan_w = torch.from_numpy(rng.random((3, 32, 32, 1), dtype=np.float32))
    with torch.no_grad():
        want = model.eval()(ms, pan_w)
    assert torch.equal(clf.logits(ms, pan_w), want)


def test_infer_cli_prints_json_line(dmx):
    out = subprocess.run(
        [sys.executable, "-m", "dmfusion_torch.infer", "--artifact",
         str(dmx), "--set", "device=cpu", "--no-maps"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["model"] == "gmfnet" and result["city"] == "synth64"
    assert result["device"] == "cpu" and 0.0 <= result["oa"] <= 1.0
    assert result["activate"] == "Relu"


def test_infer_cli_writes_maps(dmx, tmp_path, capsys):
    infer_main(["--artifact", str(dmx), "--set", "device=cpu",
                "--out", str(tmp_path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(result["maps"]) == 2
    assert all((tmp_path / p.split("/")[-1]).exists() for p in result["maps"])


def test_no_silent_cpu(dmx, monkeypatch):
    """With ``device`` left at its default and no card, the entry point
    raises instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_main(["--artifact", str(dmx), "--no-maps"])


@pytest.mark.parametrize("entry", ["load_artifact", "synthetic_scene"])
def test_no_silent_cpu_library(dmx, monkeypatch, entry):
    """The library entry points, called with no device and no card, raise;
    only an explicit ``cpu`` (argument or config) runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(overrides=OVER)
    call = {"load_artifact": lambda: load_artifact(dmx, overrides=RELU),
            "synthetic_scene": lambda: synthetic_scene(cfg)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert load_artifact(dmx, overrides={**RELU, "device": "cpu"}
                         ).device.type == "cpu"
    cpu_cfg = load_config(overrides={**OVER, "device": "cpu"})
    assert synthetic_scene(cpu_cfg).ms.device.type == "cpu"
