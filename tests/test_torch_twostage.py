"""Stage 2 of the two-stage (DQTL) solver in the port against dmfusion's, on
the CPU in float32 (synth64, patch 8, width 8), with ``dqtl.pre_trained``
and seeded stage-1 scenes: the solver's streams, its test matrices from
dmfusion's trained weights, the CLI run, export and serving, and the
refusals.

Tolerances: the four streams, the fused and per-stream test matrices, the
``streams`` sheet and every served prediction are equal to dmfusion's (or
to the solver's) exactly.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.export import load_artifact as jax_load_artifact
from dmfusion.export import save_artifact as jax_save_artifact
from dmfusion.infer import ScenePredictor as JaxScenePredictor
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion.solvers.twostage import TwoStageSolver as JaxTwoStageSolver
from dmfusion_torch import cli
from dmfusion_torch import export as export_cli
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import quad_streams, synthetic_scene
from dmfusion_torch.export import _msgpack_restore, load_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.infer import main as infer_main
from dmfusion_torch.models.convert import params_from_flax
from dmfusion_torch.ops.image import scene_to_tiles
from dmfusion_torch.ops.ihs import pan2ms
from dmfusion_torch.report.excel import Workbook
from dmfusion_torch.solvers import TwoStageSolver, build_solver
from dmfusion_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dmfusion_torch.train.steps import QuadPrograms

OVER = {"data_city": "synth64", "solver": "twostage", "model_name": "dqtl",
        "patch_size": 8, "model_width": 8, "batchsize": 32,
        "test_batchsize": 32, "color_batchsize": 32, "epoch": 1, "time": 1,
        "train_rate": 0.1, "verify_rate": 0.05, "seed": 0, "nohup": 1,
        "dqtl": {"pre_trained": 1},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
SIZE = (64, 72, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gan():
    """Seeded stand-ins of stage 1's output: ``msgan`` (its fake PAN) near
    ``pan2ms(PAN)`` and ``pangan`` (its fake MS) near MS."""
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    rng = np.random.default_rng(1)
    pms = pan2ms(torch.from_numpy(scene.raw_pan), SIZE).numpy()
    msgan = pms + 0.1 * rng.standard_normal(pms.shape)
    pangan = scene.raw_ms + 0.1 * rng.standard_normal(SIZE)
    return msgan.astype(np.float32), pangan.astype(np.float32)


def _write_gan(expo: str, arrays) -> str:
    d = os.path.join(expo, "dqtl_weights")
    os.makedirs(d, exist_ok=True)
    for name, arr in zip(("msgan.npy", "pangan.npy"), arrays):
        np.save(os.path.join(d, name), arr)
    return d


def _cfg(expo, **over):
    return load_config(overrides={**OVER, "expo_result": f"{expo}/",
                                  "device": "cpu", **over}, prepare=True)


@pytest.fixture(scope="module")
def dmfusion_run(tmp_path_factory, gan):
    """dmfusion's two-stage solver, stage 2 only (pre_trained), one epoch
    and test."""
    tmp = tmp_path_factory.mktemp("j")
    _write_gan(str(tmp), gan)
    solver = jax_build_solver(jax_load_config(
        overrides={**OVER, "expo_result": f"{tmp}/"}, prepare=True))
    solver.run()
    return solver


def test_dmfusion_weights_give_dmfusion_matrices(dmfusion_run, gan,
                                                 tmp_path):
    """The port's solver builds dmfusion's four streams; dmfusion's best
    weights, converted into the port's checkpoint, give the port's test()
    dmfusion's fused and per-stream matrices, exactly, and its workbook
    the same ``streams`` sheet."""
    jsolver = dmfusion_run
    with open(os.path.join(jsolver.cfg["RESULT_output"], "0_weights.msgpack"),
              "rb") as f:
        payload = _msgpack_restore(f.read())
    assert payload["__meta__"]["model"] == "dqtl"
    _write_gan(str(tmp_path), gan)
    solver = build_solver(_cfg(tmp_path, train={"index": 0}))
    assert isinstance(solver, TwoStageSolver)
    save_checkpoint(solver.best_weights_path(),
                    params_from_flax(payload["tree"], "DQTL"),
                    meta={"model": "dqtl", "width": 8})
    solver.run()
    assert isinstance(solver.programs, QuadPrograms)
    for got, want in zip(solver.scene_args, jsolver.scene_args, strict=True):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # Every stream is MS-geometry: the dual scene's tensors are freed.
    assert solver.scene.ms is None and solver.scene.pan is None
    assert np.array_equal(solver.test_matrix, jsolver.test_matrix)
    assert solver.stream_matrices.shape == (4, 5, 5)
    assert np.array_equal(solver.stream_matrices, jsolver.stream_matrices)
    n_test = len(solver.split.test)
    assert all(m.sum() == n_test for m in solver.stream_matrices)
    assert solver.stream_results == jsolver.stream_results
    got = Workbook.load(solver.cfg["RESULT_excel"])["streams"]
    assert [got.cell(2 + i, 1) for i in range(4)] == ["MS", "PAN", "GM",
                                                      "GP"]
    assert [[got.cell(r, c) for c in range(1, 5)] for r in range(1, 6)] == [
        ["repeat 0", "OA", "AA", "KAPPA"],
        *[[name, oa, aa, k] for name, (aa, oa, k, _) in zip(
            ("MS", "PAN", "GM", "GP"), jsolver.stream_results)]]


def test_stale_shape_refused_with_dmfusions_message(tmp_path, gan):
    """A cached ``msgan.npy`` of another scene's shape: both packages raise
    the same message."""
    wrong = np.zeros((5, 7, 4), np.float32)
    _write_gan(str(tmp_path), (wrong, gan[1]))
    from dmfusion.solvers.twostage import TwoStageSolver as JaxTwoStage
    jcfg = jax_load_config(overrides={**OVER, "expo_result": f"{tmp_path}/"},
                           prepare=True)
    with pytest.raises(ValueError, match="msgan.npy has shape") as want:
        JaxTwoStage(jcfg).train_stage2_setup()
    with pytest.raises(ValueError, match="msgan.npy has shape") as got:
        build_solver(_cfg(tmp_path)).train_stage2_setup()
    assert str(got.value) == str(want.value)


# -- stage 1 -----------------------------------------------------------------

# One device: on the test suite's 8-device CPU mesh dmfusion would round
# the stage-1 batch up to a multiple of 8.
S1 = {"gan_width": 8, "mesh": {"data": 1, "model": 1},
      "dqtl": {"pre_trained": 0, "pic_size": 32, "epochs": 1,
               "batch_size": 2, "save_model": 1}}
GAN_ROOTS = {"gP": "Generator", "gM": "Generator", "dP": "Discriminator",
             "dM": "Discriminator"}


def _jax_noise(seed, epochs, steps, shape):
    """dmfusion's stage-1 noise draws in its order: ``PRNGKey(seed + 1)``
    split per epoch, then per step, then into the MS and PAN draws."""
    rng = jax.random.PRNGKey(seed + 1)
    draws = []
    for _ in range(epochs):
        rng, sub = jax.random.split(rng)
        for key in jax.random.split(sub, steps):
            km, kp = jax.random.split(key)
            draws.append(tuple(torch.from_numpy(np.array(
                jax.random.normal(k, shape))) for k in (km, kp)))
    it = iter(draws)
    return lambda m, p: next(it)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """dmfusion's ``train_stage1`` (1 epoch, 3 steps of 2 tiles of 32),
    then the port's from dmfusion's initial params (written as the port's
    checkpoints, loaded with ``dqtl.load_model``) with dmfusion's noise."""
    tmp = tmp_path_factory.mktemp("s1")
    jsolver = JaxTwoStageSolver(jax_load_config(overrides={
        **OVER, **S1, "expo_result": f"{tmp}/j/"}, prepare=True))
    jsolver.train_stage1()
    jsolver.init_stage1_model()  # the initial params again, for the port
    solver = build_solver(_cfg(f"{tmp}/t", **{
        **S1, "dqtl": {**S1["dqtl"], "load_model": 1}}))
    for which, root in GAN_ROOTS.items():
        save_checkpoint(solver._gan_ckpt(which), params_from_flax(
            jsolver.gan_state["params"][which], root),
            meta=solver._gan_meta(which))
    solver.gan_noise = _jax_noise(0, 1, 3, (2, 32, 32, 4))
    solver.train_stage1()
    return jsolver, solver


def test_stage1_scenes_match_dmfusion(stage1):
    """msgan.npy and pangan.npy against dmfusion's ``train_stage1``: the
    first batch's tiles, made before any update, within 1e-5 (reading
    7.7e-7); the later ones, made after one and two Adam steps, within 1e-3
    (readings 1.1e-4 with one torch thread, 3.4e-4 with eight).  Each step
    moves an element whose gradient is rounding noise by up to ``lr``
    (1e-4) in either package (``test_torch_gan.py`` holds each step from
    JAX's own state), and the next fakes carry that.  The tiles equal
    dmfusion's."""
    jsolver, solver = stage1
    wdir = solver._weights_dir()
    for name, got, want in (("msgan.npy", solver.ms_gan, jsolver.ms_gan),
                            ("pangan.npy", solver.pan_gan, jsolver.pan_gan)):
        assert got.shape == SIZE and got.dtype == np.float32, name
        assert np.array_equal(np.load(os.path.join(wdir, name)), got)
        assert 0 <= got.min() and got.max() <= 1
        gt = scene_to_tiles(got, 32)[0]
        wt = scene_to_tiles(np.asarray(want), 32)[0]
        np.testing.assert_allclose(gt[:2], wt[:2], rtol=0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(gt, wt, rtol=0, atol=1e-3, err_msg=name)
    got, want = solver._stage1_tiles(), jsolver._stage1_tiles()
    assert got[2:] == want[2:] == (2, 3)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float32 and g.shape == (6, 32, 32, 4)
        assert np.array_equal(g, w)
    log = solver.stage1_log
    assert len(log["epoch_s"]) == 1 and len(log["d_loss"][0]) == 3
    assert np.isfinite(log["d_loss"] + log["g_loss"]).all()


def test_stage1_artifacts(stage1):
    """The files of dmfusion's ``test_stage1_artifacts`` and
    ``test_stage1_visual_artifacts``, the PNGs at their sizes; the real
    tiles' grids equal dmfusion's pixels."""
    jsolver, solver = stage1
    wdir, jdir = solver._weights_dir(), jsolver._weights_dir()
    for f in ("msgan.npy", "pangan.npy", "gen_p.ckpt", "gen_m.ckpt",
              "disc_p.ckpt", "disc_m.ckpt", "fake_ms.png", "fake_pan.png"):
        assert os.path.isfile(os.path.join(wdir, f)), f
    for f in ("fake_ms.png", "fake_pan.png"):
        assert _png(os.path.join(wdir, f)).shape == (64, 72, 3)
    for f in ("f_p_0.png", "f_m_0.png", "p.png", "m.png"):
        got = _png(os.path.join(wdir, "saved_images", f))
        want = _png(os.path.join(jdir, "saved_images", f))
        assert got.shape == want.shape == (32, 64, 3), f
        if f in ("p.png", "m.png"):
            assert np.array_equal(got, want), f
    tree = load_checkpoint(solver._gan_ckpt("dP"), None, strict=True)
    assert set(tree) == {k for k, _ in solver.gan_programs.nets[
        "dP"].named_parameters()}


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def test_stage1_stale_caches(stage1, capsys):
    """A ``pan.npy`` of another shape is recomputed, with dmfusion's
    message; a GAN checkpoint of another width is refused."""
    _, solver = stage1
    pan_npy = os.path.join(solver._weights_dir(), "pan.npy")
    good = np.load(pan_npy)
    np.save(pan_npy, np.zeros((5, 7, 4), np.float32))
    tiles = solver._stage1_tiles()
    assert ("[stage1] ignoring stale pan.npy cache (5, 7, 4) != (64, 72, 4)"
            in capsys.readouterr().out)
    assert tiles[1].shape == (6, 32, 32, 4)
    assert np.array_equal(np.load(pan_npy), good)
    wide = TwoStageSolver(dict(solver.cfg, gan_width=16))
    with pytest.raises(ValueError, match="different configuration"):
        wide.init_stage1_model()


def test_cli_runs_stage1_then_stage2(tmp_path, capsys):
    """``python -m dmfusion_torch.cli --solver twostage --set
    dqtl.pre_trained=0 ...``: stage 1 (2 epochs), then stage 2 on its
    scenes, then test."""
    solver = cli.main([
        "--solver", "twostage", "--city", "synth64", "--set", "device=cpu",
        "model_name=dqtl", "dqtl.pre_trained=0", "gan_width=8",
        "dqtl.pic_size=32", "dqtl.epochs=2", "dqtl.batch_size=2",
        "dqtl.save_model=1", "patch_size=8", "model_width=8",
        "batchsize=32", "test_batchsize=32", "color_batchsize=32", "epoch=1",
        "time=1", "train_rate=0.1", "verify_rate=0.05", "seed=0",
        "color.index=0", "precision.compute_dtype=float32",
        f"expo_result={tmp_path}/"])
    out = capsys.readouterr().out
    assert "[stage1] epoch 0 d_loss" in out and "[stage1] epoch 1" in out
    assert isinstance(solver, TwoStageSolver)
    wdir = solver._weights_dir()
    msgan = np.load(os.path.join(wdir, "msgan.npy"))
    pangan = np.load(os.path.join(wdir, "pangan.npy"))
    assert msgan.shape == pangan.shape == SIZE
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    for got, want in zip(solver.scene_args, quad_streams(
            scene, msgan, pangan, torch.device("cpu")), strict=True):
        assert torch.equal(got, want)
    assert solver.records["Epoch"] == [0]
    assert solver.test_matrix.sum() == len(solver.split.test)
    assert solver.stream_matrices.shape == (4, 5, 5)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, gan):
    """``python -m dmfusion_torch.cli --solver twostage --set
    model_name=dqtl dqtl.pre_trained=1 ...`` on synth64: train 2 epochs,
    test, color."""
    tmp = tmp_path_factory.mktemp("port")
    gan_dir = _write_gan(str(tmp), gan)
    solver = cli.main([
        "--solver", "twostage", "--city", "synth64", "--set", "device=cpu",
        "model_name=dqtl", "dqtl.pre_trained=1", "patch_size=8",
        "model_width=8", "batchsize=32", "test_batchsize=32",
        "color_batchsize=32", "epoch=2", "time=1", "train_rate=0.1",
        "verify_rate=0.05", "seed=0", "color.index=1", "nohup=1",
        "precision.compute_dtype=float32", f"expo_result={tmp}/"])
    return solver, gan_dir


def test_cli_trains_tests_and_colors(port_run):
    solver, _ = port_run
    assert isinstance(solver, TwoStageSolver)
    assert isinstance(solver.programs, QuadPrograms)
    out = solver.cfg["RESULT_output"]
    for name in ("0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                 "0_records.json", "0_pic_1.png", "0_pic_2.png"):
        assert os.path.isfile(os.path.join(out, name)), name
    with open(os.path.join(out, "0_records.json")) as f:
        rec = json.load(f)
    assert rec["Epoch"] == [0, 1] and all(np.isfinite(rec["Loss"]))
    assert all(0 <= oa <= 1 for oa in rec["ValOA"])
    assert len(rec["EpochTime"]) == 2
    # The train batches are trimmed to whole batches: no partial batch.
    n_train = len(solver.split.train)
    assert solver.optimizer.param_groups[0]["count"] == 2 * (n_train // 32)
    n_test = len(solver.split.test)
    assert solver.test_matrix.sum() == n_test
    assert [m.sum() for m in solver.stream_matrices] == [n_test] * 4
    sheet = Workbook.load(solver.cfg["RESULT_excel"])["streams"]
    assert [sheet.cell(2 + i, 1) for i in range(4)] == ["MS", "PAN", "GM",
                                                        "GP"]


def test_own_export_infer_round_trip(port_run, tmp_path, capsys):
    """Export the CLI run's best weights, serve them with the GAN scenes:
    the predictor's labels on the labeled pixels equal the solver's color
    map, and the infer CLI prints its JSON line."""
    solver, gan_dir = port_run
    weights = os.path.join(solver.cfg["RESULT_output"], "0_weights.pt")
    sets = ["model_name=dqtl", "patch_size=8", "model_width=8", "seed=0",
            "precision.compute_dtype=float32"]
    art = str(tmp_path / "dqtl.zip")
    export_cli.main(["--city", "synth64", "--set", *sets, "--weights",
                     weights, "--out", art])
    clf = load_artifact(art, "cpu")
    assert clf.manifest["arity"] == "quad"
    assert clf.manifest["input_shapes"] == [["4b", "8", "8", "4"]]
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    pred = ScenePredictor(clf, scene, bucket=64, gan_dir=gan_dir)
    for got, want in zip(pred.streams, solver.scene_args, strict=True):
        assert torch.equal(got, want)
    labeled = solver.split.labeled
    x, y = scene.ids_to_xy(labeled)
    assert np.array_equal(pred.predict_ids(labeled),
                          solver.color_maps[0][x, y])
    infer_main(["--artifact", art, "--set", "device=cpu", "--no-maps",
                "--gan-weights", gan_dir])
    assert '"model": "dqtl"' in capsys.readouterr().out


def test_serving_refusals(port_run, tmp_path, gan):
    """A quad artifact without ``gan_dir``, a missing GAN scene, and a GAN
    scene of another shape are each refused."""
    solver, gan_dir = port_run
    art = str(tmp_path / "dqtl.zip")
    from dmfusion_torch.export import save_artifact
    save_artifact(art, solver.cfg, solver.model)
    clf = load_artifact(art, "cpu")
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    with pytest.raises(ValueError, match="--gan-weights"):
        ScenePredictor(clf, scene, bucket=64)
    with pytest.raises(ValueError, match="--gan-weights"):
        infer_main(["--artifact", art, "--set", "device=cpu", "--no-maps"])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="msgan.npy"):
        ScenePredictor(clf, scene, bucket=64, gan_dir=str(empty))
    stale = _write_gan(str(tmp_path / "stale"),
                       (gan[0], np.zeros((5, 7, 4), np.float32)))
    with pytest.raises(ValueError, match="pangan.npy has shape"):
        ScenePredictor(clf, scene, bucket=64, gan_dir=stale)


def test_dmfusion_dmx_served(dmfusion_run, tmp_path, gan):
    """dmfusion's trained quad weights as a ``.dmx``, served by the port's
    ``ScenePredictor`` with the same GAN scenes, give dmfusion's
    predictions."""
    gan_dir = _write_gan(str(tmp_path), gan)
    cfg = jax_load_config(overrides=OVER)
    path = tmp_path / "dqtl.dmx"
    jax_save_artifact(path, cfg, dmfusion_run.best_params,
                      platforms=("cpu",))
    jscene = jax_synthetic_scene(cfg)
    ids = (np.arange(0, 300, dtype=np.int32) * 11) % jscene.num_pixels
    want = JaxScenePredictor(jax_load_artifact(path), jscene, bucket=64,
                             gan_dir=gan_dir).predict_ids(ids)
    assert len(np.unique(want)) >= 2  # trained: not one class everywhere
    clf = load_artifact(path, "cpu", overrides={"schedule": {
        "activate": "Relu"}})
    assert clf.manifest["arity"] == "quad" and clf.cfg["model_width"] == 8
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    got = ScenePredictor(clf, scene, bucket=64,
                         gan_dir=gan_dir).predict_ids(ids)
    assert got.dtype == np.int32 and np.array_equal(got, want)
