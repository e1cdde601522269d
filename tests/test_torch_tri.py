"""The tri arity of the port against dmfusion's, on the CPU in float32
(synth64, patch 8, width 8): the three-stream gather, tri_net and its
converter, ``TriPrograms``, the solver end to end, and serving.

Both packages see one MSPAN scene: the JAX side's, or the port's built
with JAX's unpooling offsets (``unpool_offsets`` routed through JAX's
draw, as ``tests/test_torch_ihs.py`` does).  Tolerances:
  * the gathers: bit-equal (the Pallas kernel in interpret mode on the
    in-scene anchors, edges included; ``gather_tri`` also on anchors past
    the scene, whose starts clamp as ``dynamic_slice``'s do);
  * the tri_net forward: atol 1e-5 (largest reading 3.4e-7);
  * ``TriPrograms``, one epoch of 3 steps, the last a partial batch, from
    the port's seeded weights carried to flax: losses, Adam moments and
    parameters atol 1e-5 (largest readings 1.2e-7, 1.4e-7, 5.5e-7), as
    ``tests/test_torch_train.py`` holds ``DualPrograms``.  The parameters
    are excepted, and held to Adam's step bound (``2 * lr`` a step),
    where a step's gradient is tiny or the two packages' gradients part
    by more than ``GRAD_REL`` of JAX's (4.4 % of the elements; the
    gradients part by at most 1.2e-6): Adam's step ``lr * m / (sqrt(v) +
    eps)`` is lr-sized whatever the gradient's size, so on a gradient
    that is rounding noise (the conv biases before a GroupNorm, 0 in
    exact arithmetic) the two packages step apart by up to 2.1e-3;
  * eval loss rtol 1e-5, confusions and predictions equal;
  * the test confusion from dmfusion's trained weights and a served
    ``.dmx``: equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.patches import gather_tri as jax_gather_tri
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.export import load_artifact as jax_load_artifact
from dmfusion.export import save_artifact as jax_save_artifact
from dmfusion.infer import ScenePredictor as JaxScenePredictor
from dmfusion.models import build_model as jax_build_model
from dmfusion.ops import pallas_gather
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import TriPrograms as JaxTriPrograms
from dmfusion_torch import cli
from dmfusion_torch import export as export_cli
from dmfusion_torch.config import load_config
from dmfusion_torch.data.patches import batched_ids_np, gather_tri
from dmfusion_torch.data.scene import mspan_scene, synthetic_scene
from dmfusion_torch.export import _msgpack_restore, load_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.infer import main as infer_main
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           opt_state_to_optax,
                                           params_from_flax, params_to_flax)
from dmfusion_torch.ops import gather, ihs
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.train.checkpoint import save_checkpoint
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import TriPrograms

OVER = {"data_city": "synth64", "model_name": "tri_net", "patch_size": 8,
        "model_width": 8, "batchsize": 32, "test_batchsize": 32,
        "color_batchsize": 32, "epoch": 1, "time": 1, "train_rate": 0.05,
        "verify_rate": 0.05, "seed": 0, "nohup": 1,
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
RELU = {"schedule": {"activate": "Relu"}}
LR, STEPS, TINY_GRAD, GRAD_REL = 1e-3, 3, 1e-7, 1e-3
BETA1 = 0.9  # optax.adam's first decay


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_offsets(seed):
    """dmfusion's unpooling offsets for ``PRNGKey(seed)``
    (``dmfusion/ops/ihs.py:66-68``), in the port's offset signature."""
    def draw(shape, t, generator):
        km, kn = jax.random.split(jax.random.PRNGKey(seed))
        return tuple(torch.from_numpy(np.asarray(
            jax.random.randint(k, shape, 0, t), np.uint8)) for k in (km, kn))
    return draw


@pytest.fixture
def jax_offsets(monkeypatch):
    monkeypatch.setattr(ihs, "unpool_offsets", _jax_offsets(OVER["seed"]))


@pytest.fixture(scope="module")
def scenes():
    """Both packages' synth64 scenes and one MSPAN built by dmfusion's
    solver convention (seed 0)."""
    jcfg = jax_load_config(overrides=OVER)
    jscene = jax_synthetic_scene(jcfg)
    from dmfusion.data.scene import prep_scene
    from dmfusion.ops.ihs import ihs_transform
    mspan = ihs_transform(jnp.asarray(jscene.raw_ms), jnp.asarray(
        jscene.raw_pan), jax.random.PRNGKey(int(jcfg["seed"])))
    mspan = prep_scene(mspan, 4 * jscene.patch, mspan.dtype)
    tscene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    return {"jcfg": jcfg, "jscene": jscene,
            "jargs": (jscene.ms, jscene.pan, mspan), "tscene": tscene,
            "targs": (tscene.ms, tscene.pan,
                      torch.from_numpy(np.array(mspan)))}


def _tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _vec(tree):
    flat = _flat(tree)
    return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                           for k in sorted(flat)])


def test_port_mspan_equals_dmfusion_with_its_offsets(scenes, jax_offsets):
    got = mspan_scene(scenes["tscene"], OVER["seed"])
    assert torch.equal(got, scenes["targs"][2])


def test_gather_tri_bit_equal(scenes):
    """The port's ``gather_tri`` and ``gather_tri_fast`` (its plain version
    on the CPU, no launch) against dmfusion's ``gather_tri`` on 128
    anchors (corners, the last row and column, and 4 past the scene) and
    against ``gather_tri_fast(interpret=True)`` on the in-scene ones."""
    jscene = scenes["jscene"]
    n, w, h = jscene.num_pixels, jscene.width, jscene.height
    rng = np.random.default_rng(3)
    ids = rng.integers(0, n, 128).astype(np.int32)
    ids[:8] = [0, n - 1, w - 1, (h - 1) * w, n - 2, 2 * w - 1, n - w, 5 * w]
    ids[8:12] = [n, n + 5 * w + 3, 2 * n, n + w - 1]
    inside = ids < n
    want = jax_gather_tri(*scenes["jargs"], jnp.asarray(ids), w, 8)
    fast = pallas_gather.gather_tri_fast(*scenes["jargs"], jnp.asarray(ids),
                                         w, 8, interpret=True)
    t_ids = torch.from_numpy(ids)
    before = gather.gather_windows_cuda.launches
    got_plain = gather_tri(*scenes["targs"], t_ids, w, 8)
    got_fast = gather.gather_tri_fast(*scenes["targs"], t_ids, w, 8)
    assert gather.gather_windows_cuda.launches == before
    shapes = [(128, 8, 8, 4), (128, 32, 32, 1), (128, 32, 32, 1)]
    for p, f, jw, jf, shape in zip(got_plain, got_fast, want, fast, shapes):
        assert p.shape == f.shape == shape
        assert np.array_equal(p.numpy(), np.asarray(jw))
        assert np.array_equal(f.numpy(), np.asarray(jw))
        assert np.array_equal(f.numpy()[inside], np.asarray(jf)[inside])


def _inputs(b=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 8, 8, 4), dtype=np.float32),
            rng.random((b, 32, 32, 1), dtype=np.float32),
            rng.random((b, 32, 32, 1), dtype=np.float32))


def test_forward_matches_flax_and_round_trips():
    jm = jax_build_model(jax_load_config(overrides=OVER))
    ins = _inputs(5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              *map(jnp.asarray, ins))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        *map(jnp.asarray, ins)))
    tree = _tree(params)
    model = load_flax_params(build_model(load_config(overrides=OVER)),
                             tree).eval()
    with torch.no_grad():
        got = model(*map(torch.from_numpy, ins)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = params_to_flax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.shape == b.shape and np.array_equal(a, b), back, tree))
    # gmfnet's tree (its shapes are enough), rooted at the same flax
    # name, is refused.
    gm = jax_build_model(jax_load_config(overrides={**OVER,
                                                    "model_name": "gmfnet"}))
    gtree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), _tree(
        jax.eval_shape(gm.init, jax.random.PRNGKey(0),
                       *map(jnp.asarray, ins[:2]))["params"]))
    with pytest.raises(ValueError):
        load_flax_params(build_model(load_config(overrides=OVER)), gtree)


def _batches(label, rng, n):
    labeled = np.flatnonzero(label.reshape(-1) != 0).astype(np.int32)
    ids = rng.choice(labeled, n, replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids, 32)
    labels = label.reshape(-1)[chunks].astype(np.int32)
    return chunks, labels, mask.astype(np.float32)


@pytest.fixture(scope="module")
def epoch(scenes):
    """One epoch of 3 steps (32 + 32 + 16 real anchors, 16 padded) in both
    packages from the same initial state; eval and predict on JAX's
    trained weights."""
    jcfg, jscene = scenes["jcfg"], scenes["jscene"]
    tcfg = load_config(overrides=OVER)
    rng = np.random.default_rng(2)
    ep = _batches(jscene.label, rng, 80)
    evb = _batches(jscene.label, rng, 90)
    jprog = JaxTriPrograms(jax_build_model(jcfg),
                           jax_make_optimizer(jcfg, STEPS), jcfg,
                           jscene.width, jscene.patch)
    # Seeded weights from the port's init, carried to flax: the programs
    # are held here, not the two inits (flax's compiles for seconds).
    p0 = params_to_flax(init_params(build_model(tcfg),
                                    torch.Generator().manual_seed(2)))
    p = jax.tree.map(jnp.asarray, p0)
    o = jprog.tx.init(p)
    o0 = _tree(o)
    jl, jgrads = [], []
    for i in range(STEPS):  # one step a call, to read each gradient
        mu0 = _vec(_tree(o)["0"]["mu"])
        p, o, loss = jprog.train_epoch(
            p, o, scenes["jargs"], *(jnp.asarray(a[i:i + 1]) for a in ep))
        jl.append(float(loss[0]))
        # optax's mu is BETA1 * mu0 + (1 - BETA1) * g: JAX's gradient.
        jgrads.append((_vec(_tree(o)["0"]["mu"]) - BETA1 * mu0) / (1 - BETA1))
    p1, o1 = _tree(p), _tree(o)
    jp1 = serialization.from_state_dict(p, p1)
    jeval = jprog.eval_epoch(jp1, scenes["jargs"], *map(jnp.asarray, evb))
    jpred = np.asarray(jprog.predict(jp1, scenes["jargs"],
                                     jnp.asarray(evb[0])))
    jlogits = np.asarray(jax.jit(lambda q, ids: jprog.apply(
        q, *jprog._gather(scenes["jargs"], ids)))(
            jp1, jnp.asarray(evb[0].reshape(-1))))

    model = load_flax_params(build_model(tcfg), p0)
    opt = make_optimizer(tcfg, model.parameters(), STEPS)
    opt_state_from_optax(o0, model, opt)
    prog = TriPrograms(model, opt, tcfg, jscene.width, jscene.patch)
    ids, labels, mask = map(torch.from_numpy, ep)
    losses, grads = [], []
    for i in range(STEPS):  # one step a call, to read each gradient
        losses.append(prog.train_epoch(scenes["targs"], ids[i:i + 1],
                                       labels[i:i + 1], mask[i:i + 1]))
        grads.append(_vec(params_to_flax(
            model, {n: q.grad for n, q in model.named_parameters()})))
    return {"jax": (p1, o1, np.asarray(jl)), "prog": prog,
            "losses": torch.cat(losses).numpy(), "grads": grads,
            "jgrads": jgrads,
            "eval": (evb, jeval, jpred, jlogits), "tcfg": tcfg}


def test_epoch_losses_moments_params(epoch):
    p1, o1, jl = epoch["jax"]
    np.testing.assert_allclose(epoch["losses"], jl, rtol=0, atol=1e-5)
    prog = epoch["prog"]
    got_o = opt_state_to_optax(prog.model, prog.optimizer)
    assert int(got_o["0"]["count"]) == int(o1["0"]["count"]) == STEPS
    for key in ("mu", "nu"):
        np.testing.assert_allclose(_vec(got_o["0"][key]), _vec(o1["0"][key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    got, want = _vec(params_to_flax(prog.model)), _vec(p1)
    g, jg = np.array(epoch["grads"]), np.array(epoch["jgrads"])
    excused = ((np.abs(g) < TINY_GRAD)
               | (np.abs(g - jg) > GRAD_REL * np.abs(jg))).any(axis=0)
    assert excused.mean() < 0.1, f"{excused.mean():.3f} of elements excused"
    diff = np.abs(got - want)
    assert diff[~excused].max() <= 1e-5
    assert diff[excused].max(initial=0) <= 2 * LR * STEPS


def test_eval_and_predict(epoch, scenes):
    evb, (jloss, jconf), jpred, jlogits = epoch["eval"]
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= 1e-4  # no argmax near-ties
    model = load_flax_params(build_model(epoch["tcfg"]), epoch["jax"][0])
    prog = TriPrograms(model, None, epoch["tcfg"], scenes["tscene"].width,
                       scenes["tscene"].patch)
    loss, conf = prog.eval_epoch(scenes["targs"], *map(torch.from_numpy, evb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert np.array_equal(conf.numpy(), np.asarray(jconf))
    assert conf.sum() == 90
    got = prog.predict(scenes["targs"], torch.from_numpy(evb[0]))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), jpred)


def test_dmfusion_weights_give_dmfusion_test_matrix(tmp_path, jax_offsets):
    """dmfusion trains and tests tri_net; its best weights, converted into
    the port's checkpoint, give the port's test() (MSPAN built with JAX's
    offsets) the same confusion, exactly."""
    jsolver = jax_build_solver(jax_load_config(
        overrides={**OVER, "expo_result": f"{tmp_path}/j/"}, prepare=True))
    jsolver.run()
    with open(os.path.join(jsolver.cfg["RESULT_output"], "0_weights.msgpack"),
              "rb") as f:
        payload = _msgpack_restore(f.read())
    assert payload["__meta__"]["model"] == "tri_net"
    state = params_from_flax(payload["tree"], "TriNet")
    solver = build_solver(load_config(
        overrides={**OVER, "expo_result": f"{tmp_path}/t/",
                   "train": {"index": 0}, "device": "cpu"}, prepare=True))
    save_checkpoint(solver.best_weights_path(), state,
                    meta={"model": "tri_net", "width": 8})
    solver.dataloader()
    solver.test()
    assert isinstance(solver.programs, TriPrograms)
    assert len(solver.scene_args) == 3
    assert np.array_equal(solver.test_matrix, jsolver.test_matrix)
    assert solver.last_result[1] == pytest.approx(jsolver.last_result[1],
                                                  abs=0)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """``python -m dmfusion_torch.cli --set model_name=tri_net ...`` on
    synth64 (the port's own seeded MSPAN)."""
    tmp = tmp_path_factory.mktemp("port")
    return cli.main([
        "--city", "synth64", "--set", "device=cpu", "model_name=tri_net",
        "patch_size=8", "model_width=8", "batchsize=32", "test_batchsize=32",
        "color_batchsize=32", "epoch=2", "time=1", "train_rate=0.05",
        "verify_rate=0.05", "seed=0", "color.index=1",
        "precision.compute_dtype=float32", f"expo_result={tmp}/"])


def test_cli_trains_tests_and_colors(port_run):
    solver = port_run
    assert isinstance(solver.programs, TriPrograms)
    ms, pan, mspan = solver.scene_args
    assert mspan.shape == pan.shape and mspan.dtype == torch.float32
    assert float((mspan - pan).abs().max()) <= 1e-5
    out = solver.cfg["RESULT_output"]
    for name in ("0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                 "0_records.json", "0_pic_1.png", "0_pic_2.png"):
        assert os.path.isfile(os.path.join(out, name)), name
    rec = solver.records
    assert rec["Epoch"] == [0, 1] and all(np.isfinite(rec["Loss"]))
    assert solver.test_matrix.sum() == len(solver.split.test)


def test_own_export_infer_round_trip(port_run, tmp_path, capsys):
    """Export the CLI run's best weights, serve them: the predictor's
    labels on the labeled pixels equal the solver's color map, and the
    infer CLI prints its JSON line; ``--map`` on tri raises."""
    solver = port_run
    weights = os.path.join(solver.cfg["RESULT_output"], "0_weights.pt")
    sets = ["model_name=tri_net", "patch_size=8", "model_width=8", "seed=0",
            "precision.compute_dtype=float32"]
    art = str(tmp_path / "tri.zip")
    export_cli.main(["--city", "synth64", "--set", *sets, "--weights",
                     weights, "--out", art])
    clf = load_artifact(art, "cpu")
    assert clf.manifest["arity"] == "tri"
    assert len(clf.manifest["input_shapes"]) == 3
    pred = ScenePredictor(clf, solver.scene, bucket=64)
    labeled = solver.split.labeled
    x, y = solver.scene.ids_to_xy(labeled)
    assert np.array_equal(pred.predict_ids(labeled),
                          solver.color_maps[0][x, y])
    infer_main(["--artifact", art, "--set", "device=cpu", "--no-maps"])
    assert '"model": "tri_net"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="no convolutional map route"):
        export_cli.main(["--city", "synth64", "--set", *sets, "--weights",
                         weights, "--map", "--out", str(tmp_path / "m.zip")])


def test_dmfusion_dmx_served(tmp_path, jax_offsets):
    """A dmfusion tri ``.dmx``, served by the port's ``ScenePredictor``
    (MSPAN from the manifest's seed, JAX's offsets), gives dmfusion's
    predictions."""
    cfg = jax_load_config(overrides=OVER)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(5),
                        *map(jnp.asarray, _inputs(1)))["params"]
    path = tmp_path / "tri.dmx"
    jax_save_artifact(path, cfg, params, platforms=("cpu",))
    jscene = jax_synthetic_scene(cfg)
    ids = (np.arange(0, 300, dtype=np.int32) * 11) % jscene.num_pixels
    want = JaxScenePredictor(jax_load_artifact(path), jscene,
                             bucket=64).predict_ids(ids)
    clf = load_artifact(path, "cpu", overrides=RELU)
    assert clf.manifest["arity"] == "tri" and clf.cfg["model_width"] == 8
    scene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    got = ScenePredictor(clf, scene, bucket=64).predict_ids(ids)
    assert got.dtype == np.int32 and np.array_equal(got, want)
