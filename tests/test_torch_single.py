"""The single arity of the port against dmfusion's, on the CPU in float32
(synth64, patch 8, width 8): the registry's module ``ARITY``,
``SinglePrograms`` through the solver, export and serving.

No model of either zoo declares ``ARITY = "single"``, so each package gets
one MS-only classifier of its own ``models/common.py`` blocks (a stem, three
residual blocks, the MLP head: gmfnet's MS branch and trunk): dmfusion's
through a module in ``sys.modules``, the port's through ``register`` and a
module ``ARITY``; the weights cross by ``models/convert.py``'s ``MSNet``
scope.

Tolerances, as ``tests/test_torch_train.py`` holds a free first epoch:
  * two epochs of the solver from the same converted initial weights: each
    epoch's loss atol 1e-5 and val loss rtol 1e-5 (readings 1.5e-6 and
    2.4e-7);
  * the test confusion and both color maps from dmfusion's trained
    weights, and the predictions of a served ``.dmx``: equal.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen
from flax import serialization

import dmfusion.models.common as jax_common
from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.export import load_artifact as jax_load_artifact
from dmfusion.export import save_artifact as jax_save_artifact
from dmfusion.infer import ScenePredictor as JaxScenePredictor
from dmfusion.models.registry import model_arity as jax_model_arity
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion_torch import export as export_cli
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.export import _msgpack_restore, load_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.models import common, registry
from dmfusion_torch.models.convert import load_flax_params, params_from_flax
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.train.checkpoint import save_checkpoint
from dmfusion_torch.train.steps import SinglePrograms

NAME = "single_ms"
OVER = {"data_city": "synth64", "model_name": NAME, "patch_size": 8,
        "model_width": 8, "batchsize": 32, "test_batchsize": 32,
        "color_batchsize": 32, "epoch": 2, "time": 1, "train_rate": 0.05,
        "verify_rate": 0.05, "seed": 0, "nohup": 1, "mesh": {"data": 1},
        "color": {"index": 1},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
RELU = {"schedule": {"activate": "Relu"}}


class JaxNet(linen.Module):
    """dmfusion's MS-only classifier: ``model(ms)``."""
    cfg: dict
    width: int = 64

    @linen.compact
    def __call__(self, ms):
        cfg = self.cfg
        act = jax_common.activation_fn(cfg)
        dt, pdt = jax_common.dtypes(cfg)
        w = int(cfg.get("model_width", self.width))
        x = jax_common.ConvBlock(w // 2, 3, 1, act, dt, pdt)(ms.astype(dt))
        for feats, stride in ((w, 1), (2 * w, 2), (4 * w, 2)):
            x = jax_common.ResBlock(feats, stride, act, dt, pdt)(x)
        return jax_common.MLPHead(cfg["Categories_Number"], hidden=2 * w,
                                  act=act, dtype=dt, param_dtype=pdt)(x)


class Net(torch.nn.Module):
    """The port's MS-only classifier: ``model(ms)`` on (B, ps, ps, C)."""
    flax_root = "MSNet"

    @classmethod
    def widths_from_tree(cls, tree):
        return {"model_width": 2 * common.tree_shape(
            tree, "ConvBlock_0", "Conv_0", "kernel")[-1]}

    def __init__(self, cfg, width=64):
        super().__init__()
        act = common.activation_fn(cfg)
        self.compute_dtype, _ = common.dtypes(cfg)
        w = int(cfg.get("model_width", width))
        c = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        self.stem = common.ConvBlock(c, w // 2, 3, 1, act)
        self.blocks = torch.nn.Sequential(
            common.ResBlock(w // 2, w, 1, act),
            common.ResBlock(w, 2 * w, 2, act),
            common.ResBlock(2 * w, 4 * w, 2, act))
        self.head = common.MLPHead(4 * w, int(cfg["Categories_Number"]),
                                   hidden=2 * w, act=act)

    def forward(self, ms):
        ms = ms.permute(0, 3, 1, 2)
        with torch.autocast(ms.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            return self.head(self.blocks(self.stem(ms)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def models():
    """Both packages' ``single_ms``: dmfusion's as the module
    ``dmfusion.models.single_ms``, the port's registered from a module of
    its own that declares the arity."""
    jmod = types.ModuleType(f"dmfusion.models.{NAME}")
    jmod.ARITY, jmod.Net = "single", JaxNet
    tmod = types.ModuleType(f"single_models.{NAME}")
    tmod.ARITY, tmod.Net = "single", Net
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, jmod.__name__, jmod)
        mp.setitem(sys.modules, tmod.__name__, tmod)
        mp.setattr(Net, "__module__", tmod.__name__)
        mp.setitem(registry._EXPLICIT, NAME, Net)
        yield


def test_module_arity_is_read(monkeypatch):
    """A registered model takes its module's ``ARITY`` (as dmfusion reads
    a model module's), after the fixed table; without one it is dual."""
    assert registry.model_arity(NAME) == jax_model_arity(NAME) == "single"
    plain = types.ModuleType("single_models.plain")

    class Plain(Net):
        pass

    monkeypatch.setitem(sys.modules, plain.__name__, plain)
    monkeypatch.setattr(Plain, "__module__", plain.__name__)
    monkeypatch.setitem(registry._EXPLICIT, "plain_ms", Plain)
    assert registry.model_arity("plain_ms") == "dual"
    assert registry.model_arity("dense_fusion") == "dense"
    assert registry.model_arity("gmfnet_conv") == "dual"
    assert registry.model_map_programs("gmfnet_conv") == "convmap"
    assert registry.model_arity("no_such_model") == "dual"


def test_unknown_module_arity_is_refused(tmp_path, monkeypatch):
    """A module arity the main solver has no programs for raises, as
    dmfusion's ``_programs_cls`` does, before any training."""
    odd = types.ModuleType("single_models.odd")
    odd.ARITY = "odd"

    class Odd(Net):
        pass

    monkeypatch.setitem(sys.modules, odd.__name__, odd)
    monkeypatch.setattr(Odd, "__module__", odd.__name__)
    monkeypatch.setitem(registry._EXPLICIT, "odd_ms", Odd)
    solver = build_solver(load_config(
        overrides={**OVER, "model_name": "odd_ms", "device": "cpu",
                   "expo_result": f"{tmp_path}/"}, prepare=True))
    solver.dataloader()
    with pytest.raises(ValueError, match="unsupported model arity 'odd'"):
        solver.train()


def _tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """dmfusion's solver (2 epochs, test, color), then the port's from
    dmfusion's seeded initial weights, converted."""
    tmp = tmp_path_factory.mktemp("runs")
    jsolver = jax_build_solver(jax_load_config(
        overrides={**OVER, "expo_result": f"{tmp}/j/"}, prepare=True))
    start = {}
    jinit = jsolver.init_model

    def jax_init():
        jinit()
        start["tree"] = _tree(jsolver.params)

    jsolver.init_model = jax_init
    jsolver.run()
    solver = build_solver(load_config(
        overrides={**OVER, "expo_result": f"{tmp}/t/", "device": "cpu"},
        prepare=True))
    tinit = solver.init_model

    def port_init():
        tinit()
        load_flax_params(solver.model, start["tree"])

    solver.init_model = port_init
    solver.run()
    return jsolver, solver


def test_training_equals_dmfusion(runs):
    jsolver, solver = runs
    assert type(solver.programs) is SinglePrograms
    assert len(solver.scene_args) == 1
    rec, jrec = solver.records, jsolver.records
    assert rec["Epoch"] == jrec["Epoch"] == [0, 1]
    np.testing.assert_allclose(rec["Loss"], jrec["Loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rec["ValLoss"], jrec["ValLoss"], rtol=1e-5)
    assert solver.test_matrix.sum() == len(solver.split.test)
    for name in ("0_weights.pt", "0_matrix.npy", "0_pic_1.png",
                 "0_pic_2.png"):
        assert os.path.isfile(os.path.join(solver.cfg["RESULT_output"],
                                           name)), name


def test_dmfusion_weights_give_dmfusion_test_and_maps(runs, tmp_path):
    """dmfusion's best weights, converted into the port's checkpoint, give
    the port's test() dmfusion's confusion and its color() dmfusion's two
    class maps."""
    jsolver, _ = runs
    with open(os.path.join(jsolver.cfg["RESULT_output"],
                           "0_weights.msgpack"), "rb") as f:
        payload = _msgpack_restore(f.read())
    assert payload["__meta__"]["model"] == NAME
    solver = build_solver(load_config(
        overrides={**OVER, "expo_result": f"{tmp_path}/", "device": "cpu",
                   "train": {"index": 0}}, prepare=True))
    save_checkpoint(solver.best_weights_path(),
                    params_from_flax(payload["tree"], "MSNet"),
                    meta={"model": NAME, "width": 8})
    solver.dataloader()
    solver.test()
    solver.color()
    assert np.array_equal(solver.test_matrix, jsolver.test_matrix)
    for got, want in zip(solver.color_maps, jsolver.color_maps, strict=True):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("bucket", [64, 1024])
def test_export_serves_the_solvers_predictions(runs, tmp_path, bucket):
    """The port's export of its run (manifest arity ``single``, dmfusion's
    one MS input), served per anchor: the solver's color map on the
    labeled pixels, at a bucket below dmfusion's fast-gather sizes and one
    among them (the port gathers both with ``gather_one_fast``)."""
    _, solver = runs
    art = str(tmp_path / "single.zip")
    export_cli.main([
        "--city", "synth64", "--set", f"model_name={NAME}", "patch_size=8",
        "model_width=8", "seed=0", "precision.compute_dtype=float32",
        "--weights", os.path.join(solver.cfg["RESULT_output"],
                                  "0_weights.pt"), "--out", art])
    clf = load_artifact(art, "cpu")
    assert clf.manifest["arity"] == "single"
    assert clf.manifest["input_shapes"] == [["b", "8", "8", "4"]]
    pred = ScenePredictor(clf, solver.scene, bucket=bucket)
    assert len(pred.streams) == 1
    labeled = solver.split.labeled
    x, y = solver.scene.ids_to_xy(labeled)
    assert np.array_equal(pred.predict_ids(labeled),
                          solver.color_maps[0][x, y])


def test_dmfusion_dmx_served(tmp_path):
    """A dmfusion single ``.dmx``, served by the port's ``ScenePredictor``
    (the widths read from its tree), gives dmfusion's predictions."""
    cfg = jax_load_config(overrides=OVER)
    params = JaxNet(cfg).init(jax.random.PRNGKey(5),
                              jnp.zeros((1, 8, 8, 4)))["params"]
    path = tmp_path / "single.dmx"
    jax_save_artifact(path, cfg, params, platforms=("cpu",))
    jscene = jax_synthetic_scene(cfg)
    ids = (np.arange(0, 300, dtype=np.int32) * 11) % jscene.num_pixels
    want = JaxScenePredictor(jax_load_artifact(path), jscene,
                             bucket=64).predict_ids(ids)
    clf = load_artifact(path, "cpu", overrides=RELU)
    assert clf.manifest["arity"] == "single" and clf.cfg["model_width"] == 8
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    got = ScenePredictor(clf, scene, bucket=64).predict_ids(ids)
    assert got.dtype == np.int32 and np.array_equal(got, want)
