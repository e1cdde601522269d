"""The ``use_h5`` patch cache of the port against dmfusion's, on the CPU
(synth64, patch 8, width 8, float32): the file, ``H5DualPrograms`` and the
solver's cache-backed training.

Tolerances:
  * the cache files: equal key by key in shape, dtype and value, and each
    package reads the other's;
  * ``H5DualPrograms``' epoch against the on-the-fly ``DualPrograms``' in
    the port: losses and parameters equal (as
    ``tests/test_solver_e2e.py`` holds dmfusion's two);
  * a ``use_h5`` solver run against dmfusion's from the same converted
    initial weights, one epoch of 11 steps: the epoch loss atol 1e-5 and
    the val loss rtol 1e-5, as ``tests/test_torch_train.py`` holds a free
    first epoch (readings 2.4e-7, and 7e-8 relative; every step within
    1e-6).  The run is seeded 1: at seed 0 the two packages' steps part
    from the third on (2e-5, then up to 1.6e-3 at the partial last
    batch), with or without the cache, the rounding at a ReLU input near 0
    that ``tests/test_torch_train.py`` describes; each package's
    cache-backed epoch equals its own scene-gathered one there.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion.utils.h5cache import read_h5 as jax_read_h5
from dmfusion.utils.h5cache import save_patches as jax_save_patches
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import load_flax_params
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.solvers.base import BaseSolver
from dmfusion_torch.train import steps
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.utils.h5cache import gather_patches, read_h5, save_patches

OVER = {"data_city": "synth64", "patch_size": 8, "model_width": 8,
        "batchsize": 32, "test_batchsize": 32, "color_batchsize": 32,
        "epoch": 1, "time": 1, "train_rate": 0.05, "verify_rate": 0.05,
        "seed": 0, "nohup": 1, "mesh": {"data": 1},
        "test": {"index": 0}, "color": {"index": 0},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(scene, n=70, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice(scene.num_pixels, n, replace=False).astype(np.int32)


def _same(a, b):
    assert sorted(a) == sorted(b) == ["label", "ms", "pan", "xy"]
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


def test_cache_file_equals_dmfusions(tmp_path):
    """Both packages' caches of the same anchors hold the same arrays, and
    each package reads the other's file."""
    jscene = jax_synthetic_scene(jax_load_config(overrides=OVER))
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    ids = _ids(scene)
    jpath, tpath = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    jax_save_patches(jpath, jscene, ids)
    save_patches(tpath, scene, ids)
    want = jax_read_h5(jpath)
    assert want["ms"].shape == (70, 8, 8, 4) and want["pan"].shape == (
        70, 32, 32, 1)
    for got in (read_h5(tpath), jax_read_h5(tpath), read_h5(jpath)):
        _same(got, want)
    split = {k: v.numpy() for k, v in gather_patches(scene, ids).items()}
    _same(split, want)


def test_h5_epoch_equals_on_the_fly():
    """One SGD epoch of two batches from the cache's rows (row ids) and
    from the scene (pixel ids), from the same seeded weights: the same
    losses and parameters."""
    cfg = load_config(overrides={**OVER, "schedule": {"optimizer": "SGD"}})
    scene = synthetic_scene(cfg, device="cpu")
    ids = _ids(scene, 64)
    patches = gather_patches(scene, ids)
    labels = torch.from_numpy(scene.label.reshape(-1)[ids].astype(
        np.int32)).reshape(2, 32)
    mask = torch.ones(2, 32)
    out = {}
    for name, cls, args, batch in (
            ("h5", steps.H5DualPrograms, (patches["ms"], patches["pan"]),
             torch.arange(64, dtype=torch.int32)),
            ("fly", steps.DualPrograms, (scene.ms, scene.pan),
             torch.from_numpy(ids))):
        model = init_params(build_model(cfg), torch.Generator().manual_seed(0))
        prog = cls(model, make_optimizer(cfg, model.parameters(), 2), cfg,
                   scene.width, scene.patch)
        losses = prog.train_epoch(args, batch.reshape(2, 32), labels, mask)
        out[name] = (losses, [p.detach().clone() for p in model.parameters()])
    assert torch.equal(out["h5"][0], out["fly"][0])
    for a, b in zip(out["h5"][1], out["fly"][1], strict=True):
        assert torch.equal(a, b)


def _tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """dmfusion's and the port's ``use_h5`` solver runs (one epoch, no
    test), the port's from dmfusion's seeded initial weights; the port's
    cache-backed gathers counted."""
    tmp = tmp_path_factory.mktemp("runs")
    over = {**OVER, "use_h5": 1, "train_rate": 0.1, "seed": 1}
    jsolver = jax_build_solver(jax_load_config(
        overrides={**over, "expo_result": f"{tmp}/j/"}, prepare=True))
    start = {}
    jinit = jsolver.init_model

    def jax_init():
        jinit()
        start["tree"] = _tree(jsolver.params)

    jsolver.init_model = jax_init
    jsolver.run()
    solver = build_solver(load_config(
        overrides={**over, "expo_result": f"{tmp}/t/", "device": "cpu"},
        prepare=True))
    tinit = solver.init_model

    def port_init():
        tinit()
        load_flax_params(solver.model, start["tree"])

    solver.init_model = port_init
    used = {"h5": 0, "fly": 0}
    h5_gather, fly_gather = steps.H5DualPrograms._gather, \
        steps.DualPrograms._gather

    def spy(self, scene_args, ids_b):
        used["h5" if isinstance(self, steps.H5DualPrograms) else "fly"] += 1
        impl = h5_gather if isinstance(self, steps.H5DualPrograms) \
            else fly_gather
        return impl(self, scene_args, ids_b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps.H5DualPrograms, "_gather", spy)
        mp.setattr(steps.DualPrograms, "_gather", spy)
        solver.run()
    return jsolver, solver, used


def test_use_h5_trains_from_the_cache_like_dmfusion(runs):
    jsolver, solver, used = runs
    steps_ = -(-len(solver.split.train) // 32)
    assert steps_ == 11
    # Train gathers from the cache; the val batches (of 64 on the CPU) from
    # the scene.
    assert used == {"h5": steps_, "fly": -(-len(solver.split.valid) // 64)}
    out, jout = solver.cfg["RESULT_output"], jsolver.cfg["RESULT_output"]
    _same(read_h5(os.path.join(out, "0_train_patches.h5")),
          jax_read_h5(os.path.join(jout, "0_train_patches.h5")))
    rec, jrec = solver.records, jsolver.records
    assert rec["Epoch"] == jrec["Epoch"] == [0]
    np.testing.assert_allclose(rec["Loss"], jrec["Loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rec["ValLoss"], jrec["ValLoss"], rtol=1e-5)


def test_use_h5_multiprocess_falls_back(tmp_path, monkeypatch):
    """In a torch.distributed world of more than one process the cache
    path warns and the run trains from scene gathers, as dmfusion's does
    under more than one JAX process."""
    solver = build_solver(load_config(
        overrides={**OVER, "use_h5": 1, "expo_result": f"{tmp_path}/",
                   "device": "cpu"}, prepare=True))
    solver.dataloader()
    solver.init_model()
    assert solver._maybe_h5_training() is not None
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.warns(UserWarning, match="single-process"):
        assert solver._maybe_h5_training() is None


def test_use_h5_without_h5py_names_it(tmp_path, monkeypatch):
    """Where h5py is missing (the machine with the card), ``use_h5`` raises
    an ImportError naming it, as dmfusion's would."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    solver = BaseSolver(load_config(
        overrides={**OVER, "use_h5": 1, "expo_result": f"{tmp_path}/",
                   "device": "cpu"}, prepare=True))
    with pytest.raises(ImportError, match="h5py"):
        solver.dataloader()
