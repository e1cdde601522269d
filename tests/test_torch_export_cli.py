"""gmfnet_conv end to end on the CPU: the port's CLI (train, test and color
by the map route), ``python -m dmfusion_torch.export --map``, serving the
artifact, dmfusion's test matrix from its converted weights, and a
dmfusion ``--map`` ``.dmx`` served by the port (synth64, patch 35, width
8, float32).

Exact throughout: the served maps equal the in-process ones, and the port
reproduces dmfusion's test confusion bit for bit from dmfusion's trained
best weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.export import load_artifact as jax_load_artifact
from dmfusion.export import save_artifact as jax_save_artifact
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion_torch import cli
from dmfusion_torch import export as export_cli
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.export import _msgpack_restore, load_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.infer import main as infer_main
from dmfusion_torch.models.convert import params_from_flax
from dmfusion_torch.report.excel import Workbook
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.train.checkpoint import save_checkpoint
from dmfusion_torch.train.steps import ConvMapPrograms

OVER = {"data_city": "synth64", "model_name": "gmfnet_conv", "patch_size": 35,
        "model_width": 8, "batchsize": 32, "test_batchsize": 32,
        "color_batchsize": 32, "epoch": 1, "time": 1, "train_rate": 0.05,
        "verify_rate": 0.05, "seed": 0, "nohup": 1,
        "color": {"index": 1, "supervised": 1, "unsupervised": 1},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
RELU = {"schedule": {"activate": "Relu"}}
SETS = ["model_name=gmfnet_conv", "patch_size=35", "model_width=8", "seed=0",
        "precision.compute_dtype=float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """``python -m dmfusion_torch.cli`` on synth64 with gmfnet_conv."""
    tmp = tmp_path_factory.mktemp("port")
    solver = cli.main([
        "--city", "synth64", "--set", "device=cpu", *SETS, "batchsize=32",
        "test_batchsize=32", "color_batchsize=32", "epoch=1", "time=1",
        "train_rate=0.05", "verify_rate=0.05", "seed=0", "color.index=1",
        "color.unsupervised=1", f"expo_result={tmp}/"])
    return solver


def test_cli_trains_and_maps_by_the_map_route(port_run):
    solver = port_run
    prog = solver.programs
    assert isinstance(prog, ConvMapPrograms) and prog.supports_map
    out = solver.cfg["RESULT_output"]
    for name in ("0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                 "0_pic_1.png", "0_pic_2.png"):
        assert os.path.isfile(os.path.join(out, name)), name
    sheet = Workbook.load(solver.cfg["RESULT_excel"]).active
    assert sheet.cell(6, 2) == "OA"
    assert np.isfinite(solver.records["Loss"]).all()
    assert solver.test_matrix.sum() == len(solver.split.test)
    _, full = solver.color_maps
    assert full.shape == (64, 72)
    # Both PNGs come from one class map of the scene.
    want = prog.predict_map(*solver.scene_args).numpy()
    np.testing.assert_array_equal(full, want)


def test_export_map_round_trip_serves_the_same_map(port_run, tmp_path,
                                                    capsys):
    solver = port_run
    weights = os.path.join(solver.cfg["RESULT_output"], "0_weights.pt")
    art = str(tmp_path / "conv.zip")
    export_cli.main(["--city", "synth64", "--set", *SETS, "--weights",
                     weights, "--map", "--out", art])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["serving"] == "map" and line["batch"] == "scene"
    clf = load_artifact(art, "cpu")
    m = clf.manifest
    assert clf.is_map and m["arity"] == "dual"
    assert m["scene_shape"] == [64, 72, 4] and m["conv_bands"] == 0
    assert m["input_shapes"] == [["98", "106", "4"], ["395", "427"]]
    assert "gmfnet_pan" not in m
    pred = ScenePredictor(clf, solver.scene)
    want = solver.programs.predict_map(*solver.scene_args).numpy()
    np.testing.assert_array_equal(pred.class_map(), want)
    res = pred.evaluate()
    assert res["pixels"] > 0 and 0.0 <= res["oa"] <= 1.0
    with pytest.raises(ValueError, match="whole scenes"):
        clf.predict(solver.scene.ms[None, :35, :35],
                    solver.scene.pan[None, :140, :140, None])
    infer_main(["--artifact", art, "--set", "device=cpu", "--no-maps"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["model"] == "gmfnet_conv"
    assert result["oa"] == pytest.approx(res["oa"], abs=0)
    # Weights of another width are refused by their identity stamp.
    with pytest.raises(ValueError, match="different configuration"):
        export_cli.main(["--city", "synth64", "--set", *SETS[:2],
                         "model_width=16", "--weights", weights, "--map",
                         "--out", art])


@pytest.mark.parametrize("model", ["gmfnet", "dense_fusion"])
def test_map_export_of_other_models_raises(tmp_path, model):
    with pytest.raises(ValueError, match="--map"):
        export_cli.main(["--city", "synth64", "--set", f"model_name={model}",
                         "patch_size=8", "model_width=8", "--random-init",
                         "--map", "--out", str(tmp_path / "x.zip")])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """dmfusion's solver trains gmfnet_conv one epoch, tests and colors."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = jax_load_config(overrides={**OVER, "expo_result": f"{tmp}/",
                                     "mesh": {"data": 1, "model": 1}},
                          prepare=True)
    solver = jax_build_solver(cfg)
    solver.run()
    with open(os.path.join(solver.cfg["RESULT_output"], "0_weights.msgpack"),
              "rb") as f:
        payload = _msgpack_restore(f.read())
    assert payload["__meta__"]["model"] == "gmfnet_conv"
    return solver, payload["tree"]


def test_dmfusion_weights_give_dmfusion_test_matrix(jax_run, tmp_path):
    jsolver, tree = jax_run
    cfg = load_config(overrides={**OVER, "expo_result": f"{tmp_path}/",
                                 "device": "cpu", "train": {"index": 0}},
                      prepare=True)
    solver = build_solver(cfg)
    save_checkpoint(solver.best_weights_path(),
                    params_from_flax(tree, "ConvNet"),
                    meta={"model": "gmfnet_conv", "width": 8})
    solver.dataloader()
    solver.test()
    assert isinstance(solver.programs, ConvMapPrograms)
    assert np.array_equal(solver.test_matrix, jsolver.test_matrix)
    assert solver.last_result[1] == pytest.approx(jsolver.last_result[1],
                                                  abs=0)


def test_dmfusion_map_dmx_served_as_a_class_map(jax_run, tmp_path):
    """C4: a dmfusion ``--map`` ``.dmx`` (arity ``dual``, ``serving:
    "map"``) is served by the port as one class map equal to dmfusion's."""
    jsolver, tree = jax_run
    path = tmp_path / "conv.dmx"
    params = jax.tree.map(jnp.asarray, tree)
    manifest = jax_save_artifact(path, jsolver.cfg, params,
                                 platforms=("cpu",), map_route=True)
    assert manifest["arity"] == "dual" and manifest["serving"] == "map"
    jscene = jax_synthetic_scene(jsolver.cfg)
    want = np.asarray(jax_load_artifact(path).class_map(jscene.ms,
                                                        jscene.pan))
    in_process = np.asarray(jsolver.programs.predict_map(
        params, (jscene.ms, jscene.pan)))
    np.testing.assert_array_equal(want, in_process)

    clf = load_artifact(path, "cpu", overrides=RELU)
    assert clf.is_map
    scene = synthetic_scene(load_config(overrides={**OVER, "device": "cpu"}))
    got = clf.class_map(scene.ms, scene.pan).numpy()
    assert got.shape == want.shape == (64, 72)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ScenePredictor(clf, scene).class_map(),
                                  want)
    with pytest.raises(ValueError, match="whole scenes"):
        clf.predict(scene.ms[None, :35, :35], scene.pan[None, :140, :140,
                                                        None])
