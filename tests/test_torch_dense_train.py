"""Dense training: the port's ``DensePrograms`` (minibatch, full-batch and
streamed epochs, remat, eval, predict, test confusion), its SAT pieces,
the memory probes and the solver's dense arity, against dmfusion's, in
float32 on the CPU.

Numpy-seeded scenes and batches; flax weights converted with
``load_flax_params``, Adam state with ``opt_state_from_optax``.  Widths 8
and 16, patches 8 and 16 (and 7 for the odd SAT).  Tolerances, with the
largest readings behind them:

  * SAT window sums: 1e-5 relative to the largest window sum (dmfusion's
    SAT is triangular matmuls, the port's ``cumsum``: another f32
    association; read 1.2e-7 to 4.8e-7);
  * minibatch steps, at seeds 0-3, an epoch of 3 steps (the last half
    padding, masked): losses of the free-running epoch within 1e-5 (read
    9.5e-7).  Each step is also run in the port from dmfusion's state
    before it: its gradient within ``GRAD_ATOL`` of dmfusion's (read
    7.8e-8; dmfusion's gradient is read from Adam's first moment) except
    at a step whose forward meets a ReLU input within ``KINK`` (an order-1
    pre-activation's own f32 rounding) of zero.  Of some 10^6 ReLU inputs
    a step, the smallest lies at 2e-9 to 3e-7; where rounding puts it on
    the other side of zero in one package, the weight gradients upstream
    move.  Seed 0's second step is that case: an input at 9.3e-9,
    gradients apart by 2.2e-4, the loss equal; so is seed 1's full-batch
    step (2.4e-8, 1.1e-4).  Inputs at 2.1e-9 (seed 4) and 2.4e-8 (seed 1's
    first minibatch step) fell on the same side in both.  Which steps
    part is asserted.  Parameters after a
    step within 1e-5 (read 6.4e-7), except where dmfusion's gradient is
    under ``TINY_GRAD`` (Adam turns rounding there into an lr-sized step)
    or, at the kink, the two gradients part by more than ``GRAD_REL``:
    those are held to Adam's step bound, ``2 * lr``.  The free-running
    epoch's parameters are held the same way where no step parts;
  * full-batch epochs, the same rules (one update);
  * streamed pooling (2 and 3 bands) against the whole pass: pooled rows
    within 1e-6 (read 2.4e-7: the band SATs sum in another order), a
    step's loss within 1e-6 and gradients within 1e-5 of the largest;
  * remat on against off: losses and gradients bit for bit;
  * eval: loss sums rtol 1e-5, confusions, predictions and test
    confusions equal; the test asserts that no eval anchor's top-two
    logits lie within 1e-4 (the head's second kernel is scaled by 50 so
    logits have a scale near 1);
  * the solver's test matrix from dmfusion's converted best weights:
    equal, or apart only at test anchors where dmfusion's top-two logit
    gap is under 1e-3 (2 such anchors of 2,899; the flips are counted).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

import dmfusion.solvers.main as jax_main
from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.models import build_model as jax_build_model
from dmfusion.models import dense_fusion as jdense
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import DensePrograms as JaxDensePrograms
from dmfusion_torch import cli
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.export import _msgpack_restore
from dmfusion_torch.models import build_model
from dmfusion_torch.models import dense_fusion as tdense
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           params_from_flax, params_to_flax)
from dmfusion_torch.ops.metrics import render_class_map
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.solvers import main as port_main
from dmfusion_torch.train.checkpoint import save_checkpoint
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import DensePrograms, resolve_dense_epoch

F32 = {"compute_dtype": "float32", "param_dtype": "float32"}
OVER = {"data_city": "synth64", "model_name": "dense_fusion",
        "patch_size": 8, "model_width": 8, "batchsize": 32, "seed": 0,
        "train": {"dense_remat": "on"}, "precision": F32}
# A scene of 96 anchor rows: it splits into 2 and into 3 bands.
TALL = {"DATA_DICT": {"synthtall": {
    "size": [96, 40, 4],
    "color": [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]]}},
    "data_city": "synthtall"}
LR = 1e-3
BETA1 = 0.9  # optax.adam's first decay
STEPS = 3
SEEDS = (0, 1, 2, 3)
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6
KINK = 1e-7
TINY_GRAD = 1e-7
GRAD_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(x):
    return jax.tree.map(np.array, serialization.to_state_dict(x))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _vec(tree):
    """A flax-layout tree as one float64 vector, leaves in key order."""
    flat = _flat(tree)
    return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                           for k in sorted(flat)])


def _watch_relu(model):
    """Record, per forward, the smallest |input| of any activation."""
    seen = []
    for m in model.modules():
        if isinstance(m, (tdense.LocalConvBlock, tdense.LocalResBlock)):
            act = m.act

            def wrapped(x, act=act):
                seen[-1] = min(seen[-1], float(x.detach().abs().min()))
                return act(x)
            m.act = wrapped
    return seen


def _batches(label, rng, n_real, steps=STEPS, batch=32):
    """(steps, batch) ids, labels, mask of ``n_real`` labeled anchors, the
    rest padding (anchor 0, masked)."""
    labeled = np.flatnonzero(label.reshape(-1) != 0)
    ids = np.zeros(steps * batch, np.int32)
    ids[:n_real] = rng.choice(labeled, n_real, replace=False)
    mask = np.zeros(steps * batch, np.float32)
    mask[:n_real] = 1
    shape = (steps, batch)
    return (ids.reshape(shape), label.reshape(-1)[ids].astype(np.int32)
            .reshape(shape), mask.reshape(shape))


def _port_programs(cfg, params, opt_state=None):
    model = load_flax_params(build_model(cfg), params)
    opt = make_optimizer(cfg, model.parameters(), STEPS)
    if opt_state is not None:
        opt_state_from_optax(opt_state, model, opt)
    return DensePrograms(model, cfg["patch_size"], optimizer=opt, cfg=cfg)


def _grad_vec(model):
    return _vec(params_to_flax(model, {n: p.grad for n, p in
                                       model.named_parameters()}))


def _jax_grad(before, after):
    """dmfusion's gradient of a step: optax's mu is b1 mu0 + (1-b1) g."""
    mu0, mu = _vec(before[1]["0"]["mu"]), _vec(after[1]["0"]["mu"])
    return (mu - BETA1 * mu0) / (1 - BETA1)


# -- SAT pieces --------------------------------------------------------------

@pytest.mark.parametrize("ps", [8, 16])
def test_phase_corner_sums_match_pooled_map_and_jax(ps):
    rng = np.random.default_rng(ps)
    h2, w2, c = 23, 29, 6
    f = rng.standard_normal((h2, w2, 4 * c)).astype(np.float32)
    out_r, out_c = 2 * h2 - ps + 1, 2 * w2 - ps + 1
    x = rng.integers(0, out_r, 300).astype(np.int32)
    y = rng.integers(0, out_c, 300).astype(np.int32)
    x[:2], y[:2] = (0, out_r - 1), (0, out_c - 1)
    js = jdense.phase_sat(jnp.asarray(f))
    want = np.asarray(jdense.phase_corner_sums(
        js.reshape(-1, 4 * c), js.shape[1], ps, jnp.asarray(x),
        jnp.asarray(y)))
    ts = tdense.phase_sat(torch.from_numpy(f))
    assert ts.dtype == torch.float32 and ts.shape == js.shape
    got = tdense.phase_corner_sums(ts.reshape(-1, 4 * c), ts.shape[1], ps,
                                   torch.from_numpy(x), torch.from_numpy(y))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    pooled = tdense.phase_window_mean(torch.from_numpy(f), ps, out_r, out_c)
    np.testing.assert_allclose((got / ps ** 2).numpy(),
                               pooled.numpy()[x, y], rtol=0,
                               atol=1e-5 * scale / ps ** 2)
    # extra rows and columns of zeros after the last ones
    ext = tdense.phase_sat(torch.from_numpy(f), extra=1)
    assert ext.shape == (h2 + 2, w2 + 2, 4 * c)
    assert torch.equal(ext[:-1, :-1], ts)


def test_sat_window_sums_odd_patch_match_jax():
    ps = 7
    f = np.random.default_rng(7).standard_normal((30, 33, 5)
                                                 ).astype(np.float32)
    jflat, jw1 = jdense.sat_window_sums(jnp.asarray(f), ps)
    flat, w1 = tdense.sat_window_sums(torch.from_numpy(f), ps)
    assert w1 == jw1 == 34 and flat.shape == jflat.shape
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jflat)).max())


# -- minibatch and full-batch epochs ----------------------------------------

@pytest.fixture(scope="module")
def jax_minibatch():
    jcfg = jax_load_config(overrides=OVER)
    scene = jax_synthetic_scene(jcfg)
    jprog = JaxDensePrograms(jax_build_model(jcfg),
                             jax_make_optimizer(jcfg, STEPS), jcfg,
                             scene.width, scene.patch, None)
    tcfg = load_config(overrides=OVER)
    tscene = synthetic_scene(tcfg, device="cpu")
    return jprog, scene, tcfg, (tscene.ms, tscene.pan)


@pytest.fixture(scope="module", params=SEEDS)
def run(request, jax_minibatch):
    """dmfusion's epoch one step at a time; the port's epoch free-running
    from the same state, and each of its steps from dmfusion's state
    before it."""
    seed = request.param
    jprog, scene, tcfg, targs = jax_minibatch
    jargs = (scene.ms, scene.pan)
    batches = _batches(scene.label, np.random.default_rng(seed), 80)
    p, o = jprog.init(jax.random.PRNGKey(seed))
    jsteps = []
    for i in range(STEPS):
        before = (_tree(p), _tree(o))
        p, o, loss = jprog.train_epoch(
            p, o, jargs, *(jnp.asarray(a[i:i + 1]) for a in batches))
        jsteps.append((before, (_tree(p), _tree(o)), float(loss[0])))

    tb = [torch.from_numpy(a) for a in batches]
    free = _port_programs(tcfg, *jsteps[0][0])
    free_losses = free.train_epoch(targs, *tb).numpy()
    per_step = []
    for i, (before, _, _) in enumerate(jsteps):
        prog = _port_programs(tcfg, *before)
        seen = _watch_relu(prog.model)
        seen.append(float("inf"))
        loss = prog.train_epoch(targs, *(t[i:i + 1] for t in tb))
        per_step.append({"loss": float(loss[0]),
                         "grad": _grad_vec(prog.model),
                         "params": _vec(params_to_flax(prog.model)),
                         "kink": seen[0] < KINK})
    return {"seed": seed, "jsteps": jsteps, "free_losses": free_losses,
            "free_params": _vec(params_to_flax(free.model)),
            "per_step": per_step}


def test_minibatch_losses(run):
    want = np.array([loss for _, _, loss in run["jsteps"]])
    assert run["free_losses"].shape == (STEPS,)
    np.testing.assert_allclose(run["free_losses"], want, rtol=0,
                               atol=LOSS_ATOL)
    got = np.array([s["loss"] for s in run["per_step"]])
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def test_minibatch_gradients_part_only_at_relu_kinks(run):
    parted = []
    for (before, after, _), step in zip(run["jsteps"], run["per_step"]):
        gap = np.abs(step["grad"] - _jax_grad(before, after)).max()
        assert gap <= GRAD_ATOL or step["kink"], gap
        parted.append(gap > GRAD_ATOL)
    # Seed 0's second step is the case the exception is for.
    assert parted == [run["seed"] == 0 and i == 1 for i in range(STEPS)]


def test_minibatch_params(run):
    tiny_any = np.zeros_like(run["free_params"], dtype=bool)
    for (before, after, _), step in zip(run["jsteps"], run["per_step"]):
        jg = _jax_grad(before, after)
        excused = np.abs(jg) < TINY_GRAD
        tiny_any |= excused
        if step["kink"]:
            excused |= np.abs(step["grad"] - jg) > GRAD_REL * np.abs(jg)
        else:
            assert excused.mean() < 0.02
        diff = np.abs(step["params"] - _vec(after[0]))
        assert diff[~excused].max() <= 1e-5
        assert diff[excused].max(initial=0) <= 2 * LR
    if run["seed"] != 0:  # no step parted: the free-running epoch too
        diff = np.abs(run["free_params"] - _vec(run["jsteps"][-1][1][0]))
        assert diff[~tiny_any].max() <= 1e-5
        assert diff[tiny_any].max(initial=0) <= 2 * LR * STEPS


@pytest.fixture(scope="module")
def jax_full():
    over = {**OVER, "train": {"dense_remat": "on", "dense_epoch": "full"}}
    jcfg = jax_load_config(overrides=over)
    scene = jax_synthetic_scene(jcfg)
    jprog = JaxDensePrograms(jax_build_model(jcfg),
                             jax_make_optimizer(jcfg, 1), jcfg,
                             scene.width, scene.patch, None)
    assert jprog.dense_epoch_mode == "full"
    tcfg = load_config(overrides=over)
    tscene = synthetic_scene(tcfg, device="cpu")
    return jprog, scene, tcfg, (tscene.ms, tscene.pan)


@pytest.mark.parametrize("seed", SEEDS)
def test_full_epoch(jax_full, seed):
    """One dense pass over every train anchor, one update."""
    jprog, scene, tcfg, targs = jax_full
    batches = _batches(scene.label, np.random.default_rng(seed + 10), 80)
    p, o = jprog.init(jax.random.PRNGKey(seed))
    before = (_tree(p), _tree(o))
    p, o, jloss = jprog.train_epoch(p, o, (scene.ms, scene.pan),
                                    *map(jnp.asarray, batches))
    after = (_tree(p), _tree(o))
    prog = _port_programs(tcfg, *before)
    assert prog.dense_epoch_mode == "full"
    seen = _watch_relu(prog.model)
    seen.append(float("inf"))
    loss = prog.train_epoch(targs, *map(torch.from_numpy, batches))
    assert loss.shape == (1,) == jloss.shape
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=0,
                               atol=LOSS_ATOL)
    assert prog.optimizer.param_groups[0]["count"] == 1
    g, jg = _grad_vec(prog.model), _jax_grad(before, after)
    kink = seen[0] < KINK
    gap = np.abs(g - jg).max()
    assert gap <= GRAD_ATOL or kink
    assert (gap > GRAD_ATOL) == (seed == 1)  # the kink of the docstring
    excused = np.abs(jg) < TINY_GRAD
    if kink:
        excused |= np.abs(g - jg) > GRAD_REL * np.abs(jg)
    diff = np.abs(_vec(params_to_flax(prog.model)) - _vec(after[0]))
    assert diff[~excused].max() <= 1e-5
    assert diff[excused].max(initial=0) <= 2 * LR


def test_resolve_dense_epoch_matches_jax():
    from dmfusion.train.steps import resolve_dense_epoch as jax_resolve
    for value in ("auto", "minibatch", "full", None, " Full "):
        for streams in (0, 3):
            assert resolve_dense_epoch(value, streams) == jax_resolve(value,
                                                                      streams)
    with pytest.raises(ValueError, match="dense_epoch"):
        resolve_dense_epoch("sometimes", 0)
    with pytest.raises(ValueError, match="dense_epoch"):
        DensePrograms(None, 8, cfg={"train": {"dense_epoch": "nope"}})


# -- streamed pooling and remat (the port against itself) -------------------

@pytest.fixture(scope="module")
def tall():
    """The tall scene, seeded w8 weights and 2 batches of 32 anchors."""
    cfg = load_config(overrides={**OVER, **TALL})
    scene = synthetic_scene(cfg, device="cpu")
    state = init_params(build_model(cfg),
                        torch.Generator().manual_seed(4)).state_dict()
    batches = _batches(scene.label, np.random.default_rng(4), 64, steps=2)
    return cfg, scene, state, [torch.from_numpy(a) for a in batches]


def _tall_step(tall, remat=True, **over):
    """One step's loss and gradients (no update) on the tall scene."""
    cfg, scene, state, (ids, labels, mask) = tall
    cfg = {**cfg, **over}
    model = build_model(cfg)
    model.load_state_dict(state)
    model.remat = remat
    prog = DensePrograms(model, 8, cfg=cfg)
    pooled = prog._anchor_pooled_fn(*scene.ms.shape[:2])
    loss = prog._loss(pooled, (scene.ms, scene.pan), ids.reshape(-1),
                      labels.reshape(-1), mask.reshape(-1))
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    with torch.no_grad():
        feats = pooled(scene.ms, scene.pan, ids.reshape(-1))
    return loss.detach(), grads, feats, prog


@pytest.mark.parametrize("n_bands", [2, 3])
def test_streamed_pooling_matches_whole_pass(tall, n_bands):
    loss_w, grads_w, feats_w, prog_w = _tall_step(tall, dense_streams="off")
    loss_s, grads_s, feats_s, prog_s = _tall_step(tall,
                                                  dense_streams=n_bands)
    rows = tall[1].ms.shape[0]
    assert prog_w._stream_bands(rows, 47) == 0
    assert prog_s._stream_bands(rows, 47) == n_bands
    assert prog_s.band_plan(rows, n_bands) is not None
    np.testing.assert_allclose(feats_s.numpy(), feats_w.numpy(), rtol=0,
                               atol=1e-6)
    assert abs(float(loss_s) - float(loss_w)) <= 1e-6
    scale = max(float(g.abs().max()) for g in grads_w)
    for gs, gw in zip(grads_s, grads_w):
        assert float((gs - gw).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("streams", ["off", 3])
def test_remat_on_equals_off(tall, streams):
    """Checkpointing recomputes the same forward: bit for bit on the CPU."""
    on = _tall_step(tall, remat=True, dense_streams=streams)
    off = _tall_step(tall, remat=False, dense_streams=streams)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def test_remat_checkpoints_blocks_only_under_grad(monkeypatch, tall):
    cfg, scene = tall[0], tall[1]
    calls = []
    real = tdense.checkpoint
    monkeypatch.setattr(tdense, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn) or real(
                            fn, *a, **k))
    model = init_params(build_model(cfg), torch.Generator().manual_seed(0))
    assert model.remat
    model.features_s2d(scene.ms, scene.pan)
    assert len(calls) == 7  # stems, blocks, trunk, refine; not the gate
    assert model.fusion_gate not in calls
    with torch.no_grad():
        model.features_s2d(scene.ms, scene.pan)
    assert len(calls) == 7
    off = build_model({**cfg, "train": {**cfg["train"], "dense_remat": "off"}})
    assert not off.remat


# -- eval, predict, test confusion ------------------------------------------

def _eval_case(over, seed):
    """dmfusion's programs, numpy-seeded weights with logits near 1, eval
    batches with a masked tail; the port's programs on the same weights."""
    jcfg = jax_load_config(overrides=over)
    scene = jax_synthetic_scene(jcfg)
    jm = jax_build_model(jcfg)
    jprog = JaxDensePrograms(jm, jax_make_optimizer(jcfg, 1), jcfg,
                             scene.width, scene.patch, None)
    p, _ = jprog.init(jax.random.PRNGKey(seed))
    tree = _tree(p)
    tree["head2_kernel"] = tree["head2_kernel"] * 50.0
    params = jax.tree.map(jnp.asarray, tree)
    batches = _batches(scene.label, np.random.default_rng(seed), 90,
                       steps=2, batch=64)
    jargs = (scene.ms, scene.pan)
    jb = tuple(map(jnp.asarray, batches))
    want = {"eval": jprog.eval_epoch(params, jargs, *jb),
            "predict": np.asarray(jprog.predict(params, jargs, jb[0])),
            "test": np.asarray(jprog.test_confusion(params, jargs, *jb))}
    logits = np.asarray(jm.apply({"params": params}, scene.ms,
                                 scene.pan[..., None], scene.patch))
    tcfg = load_config(overrides=over)
    tscene = synthetic_scene(tcfg, device="cpu")
    prog = DensePrograms(load_flax_params(build_model(tcfg), tree),
                         tcfg["patch_size"], cfg=tcfg)
    return (prog, (tscene.ms, tscene.pan),
            tuple(map(torch.from_numpy, batches)), want, logits, jprog)


@pytest.mark.parametrize("case", ["whole", "streamed"])
def test_eval_predict_and_test_confusion(case):
    over = OVER if case == "whole" else {**OVER, **TALL, "dense_streams": 3}
    prog, targs, batches, want, logits, jprog = _eval_case(over, 5)
    streamed = prog._eval_stream_plan(targs[0]) is not None
    assert streamed == (case == "streamed")
    assert streamed == (jprog._eval_stream_plan(
        (jnp.asarray(targs[0].numpy()), None)) is not None)
    top2 = np.sort(logits.reshape(-1, logits.shape[-1])[
        batches[0].numpy().reshape(-1)], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= 1e-4
    assert np.abs(logits).max() > 0.3
    loss, conf = prog.eval_epoch(targs, *batches)
    jloss, jconf = want["eval"]
    assert loss.dtype == conf.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert np.array_equal(conf.numpy(), np.asarray(jconf))
    assert conf.sum() == 90  # the padding is masked out
    pred = prog.predict(targs, batches[0])
    assert pred.dtype == torch.int32
    assert np.array_equal(pred.numpy(), want["predict"])
    test = prog.test_confusion(targs, *batches)
    assert np.array_equal(test.numpy(), want["test"])
    assert prog.supports_map is True


def test_streamed_eval_skips_batches_without_owned_anchors():
    """A band builds its SAT once and scores only the batches that own an
    anchor in it; every anchor is scored once."""
    over = {**OVER, **TALL, "dense_streams": 3}
    tcfg = load_config(overrides=over)
    scene = synthetic_scene(tcfg, device="cpu")
    prog = DensePrograms(build_model(tcfg), 8, cfg=tcfg)
    plan = prog._eval_stream_plan(scene.ms)
    # batch 0 in the top rows, batch 1 in the bottom rows
    ids = torch.tensor([[0, 40, 5 * 40 + 3], [95 * 40, 94 * 40 + 7, 90 * 40]],
                       dtype=torch.int32)
    with torch.no_grad():
        seen = [(b, int(own.sum())) for b, _, own in
                prog._band_anchor_scan(scene.ms, scene.pan, plan, ids)]
    assert seen == [(0, 3), (1, 3)]


# -- memory probes ------------------------------------------------------------

def _fake_scene(rows, cols):
    ms = types.SimpleNamespace(shape=(rows, cols, 4),
                               device=torch.device("cpu"))
    return types.SimpleNamespace(ms=ms, pan=None)


@pytest.mark.parametrize("width", [8, 32])
def test_remat_probe_cpu_answer_is_jax_fallback(monkeypatch, width):
    """On the CPU the probe answers with dmfusion's byte estimate: its
    fallback when its compile fails."""
    def failing(*a, **k):
        raise RuntimeError("no compile here")
    monkeypatch.setattr(jax_main, "dense_remat_probe", failing)
    cfg = load_config(overrides={**OVER, "model_width": width,
                                 "train": {"dense_remat": "auto"}})
    answers = set()
    for rows, cols in ((71, 79), (2016, 2116), (4000, 4100), (8000, 8300)):
        scene = _fake_scene(rows, cols)
        got = port_main.dense_remat_probe(cfg, scene, None)
        jself = types.SimpleNamespace(mesh=None, scene=scene, split=None)
        with pytest.warns(UserWarning, match="falling back"):
            want = jax_main.Solver._resolve_dense_remat(jself, cfg)
        assert got["decision"] == want
        answers.add(want)
    assert answers == {"on", "off"}


@pytest.mark.parametrize("remat,infer", [("on", "4"), ("off", "train"),
                                         ("auto", "off"), ("0", "2")])
def test_explicit_probe_values_pass_through(monkeypatch, remat, infer):
    """Explicit ``train.dense_remat`` and ``dense_streams_infer`` values
    skip the probes and resolve as dmfusion's do."""
    def failing(*a, **k):
        raise AssertionError("probe ran for an explicit value")
    monkeypatch.setattr(port_main, "dense_infer_band_probe", failing)
    if remat != "auto":
        monkeypatch.setattr(port_main, "dense_remat_probe", failing)
    cfg = load_config(overrides={**OVER, "dense_streams_infer": infer,
                                 "train": {"dense_remat": remat}})
    scene = _fake_scene(71, 79)
    model = types.SimpleNamespace(remat=True)
    me = types.SimpleNamespace(scene=scene, model=model, remat_probe=None)
    out = port_main.Solver._resolve_dense_memory(me, cfg, 3, 100)
    jself = types.SimpleNamespace(mesh=None, scene=scene, split=None)
    want_remat = jax_main.Solver._resolve_dense_remat(jself, cfg) \
        if remat != "auto" else "off"
    assert out["train"]["dense_remat"] == want_remat
    assert model.remat == (want_remat == "on")
    want_infer = jax_main.Solver._resolve_infer_bands(jself, cfg, 3)
    assert out["dense_streams_infer"] == str(want_infer)
    assert (me.remat_probe is not None) == (remat == "auto")


def test_band_probe_on_cpu_is_training_count():
    cfg = load_config(overrides=OVER)
    assert port_main.dense_infer_band_probe(cfg, _fake_scene(9000, 9000),
                                            None, 8) == 8


# -- the solver, end to end -------------------------------------------------

SOLVER_SET = ["--city", "synth64", "--set", "device=cpu",
              "model_name=dense_fusion", "patch_size=8", "model_width=16",
              "batchsize=32", "test_batchsize=32", "color_batchsize=32",
              "epoch=3", "time=1", "train_rate=0.05", "verify_rate=0.05",
              "seed=0", "color.index=1", "precision.compute_dtype=float32",
              "precision.param_dtype=float32"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    return cli.main([*SOLVER_SET, f"expo_result={tmp}/"])


def test_solver_cli_end_to_end(port_run, capsys):
    solver = port_run
    out = solver.cfg["RESULT_output"]
    for name in ("0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                 "0_records.json", "0_pic_1.png", "0_pic_2.png"):
        assert os.path.isfile(os.path.join(out, name)), name
    assert os.path.isfile(solver.cfg["RESULT_excel"])
    assert isinstance(solver.programs, DensePrograms)
    assert solver.programs.dense_epoch_mode == "minibatch"
    assert solver.remat_probe["decision"] == "off"
    assert solver.model.remat is False
    rec = solver.records
    assert rec["Epoch"] == [0, 1, 2] and all(np.isfinite(rec["Loss"]))
    assert solver.test_matrix.sum() == len(solver.split.test)
    # one class map fills both PNGs
    with torch.inference_mode():
        cmap = solver.programs.predict_map(*solver.scene_args).numpy()
    lab1, lab2 = solver.color_maps
    assert np.array_equal(lab2, cmap)
    labeled = solver.scene.label != 0
    assert np.array_equal(lab1[labeled], cmap[labeled])
    assert not lab1[~labeled].any()
    palette = torch.tensor(solver.cfg["DATA_DICT"]["synth64"]["color"],
                           dtype=torch.uint8)
    img = np.asarray(Image.open(os.path.join(out, "0_pic_2.png")))
    assert np.array_equal(img, render_class_map(torch.from_numpy(cmap),
                                                palette).numpy())


@pytest.mark.parametrize("mode", ["minibatch", "full"])
def test_solver_shuffle_draws_like_dmfusion(tmp_path, mode):
    """Full-batch epochs build the train batches once: the shuffle
    generator advances once for them, not once an epoch, as in dmfusion;
    the schedule counts one update an epoch."""
    solver = build_solver(load_config(overrides={
        **OVER, "device": "cpu", "expo_result": f"{tmp_path}/", "epoch": 2,
        "time": 1, "train_rate": 0.05, "verify_rate": 0.05, "nohup": 1,
        "train": {"dense_epoch": mode}}, prepare=True))
    solver.dataloader()
    solver.train()
    rng = np.random.default_rng(int(solver.cfg["seed"]))
    rng.permutation(solver.split.labeled)  # the split
    for _ in range(2 if mode == "minibatch" else 1):
        rng.permutation(solver.split.train)
    assert (solver._epoch_rng.bit_generator.state
            == rng.bit_generator.state)
    steps = -(-len(solver.split.train) // 32)
    assert solver.optimizer.param_groups[0]["count"] == (
        2 * steps if mode == "minibatch" else 2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    over = {"data_city": "synth64", "model_name": "dense_fusion",
            "patch_size": 8, "model_width": 16, "batchsize": 32,
            "test_batchsize": 32, "color_batchsize": 32, "epoch": 3,
            "time": 1, "train_rate": 0.05, "verify_rate": 0.05, "seed": 0,
            "nohup": 1, "mesh": {"data": 1}, "expo_result": f"{tmp}/",
            "train": {"dense_remat": "off"}, "color": {"index": 0},
            "precision": F32}
    solver = jax_build_solver(jax_load_config(overrides=over, prepare=True))
    solver.run()
    return solver


def test_dmfusion_weights_give_dmfusion_test_matrix(tmp_path, jax_run):
    """dmfusion trains and tests; its best weights, converted into the
    port's checkpoint, give the port's test() dmfusion's confusion, but
    for flips at dmfusion's near ties."""
    jout = jax_run.cfg["RESULT_output"]
    with open(os.path.join(jout, "0_weights.msgpack"), "rb") as f:
        payload = _msgpack_restore(f.read())
    assert payload["__meta__"]["model"] == "dense_fusion"
    state = params_from_flax(payload["tree"], root="DenseNet")
    solver = build_solver(load_config(overrides={
        "data_city": "synth64", "model_name": "dense_fusion",
        "patch_size": 8, "model_width": 16, "test_batchsize": 32,
        "epoch": 3, "time": 1, "train_rate": 0.05, "verify_rate": 0.05,
        "seed": 0, "nohup": 1, "device": "cpu", "precision": F32,
        "expo_result": f"{tmp_path}/", "train": {"index": 0}},
        prepare=True))
    save_checkpoint(solver.best_weights_path(), state,
                    meta={"model": "dense_fusion", "width": 16})
    solver.dataloader()
    solver.test()
    want = jax_run.test_matrix
    assert solver.test_matrix.dtype == np.float32
    assert solver.test_matrix.sum() == want.sum() == len(solver.split.test)
    # The anchors where the two part, against dmfusion's near ties.
    test = jax_run.split.test
    jlogits = np.asarray(jax_run.programs._logits_map(
        jax_run.best_params, jax_run.scene_args)).reshape(-1, 5)[test]
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    ties = (top2[:, 1] - top2[:, 0]) < 1e-3
    with torch.inference_mode():
        got = solver.model(*solver.scene_args, 8).reshape(-1, 5)[test]
    flips = got.argmax(-1).numpy() != jlogits.argmax(-1)
    assert not (flips & ~ties).any()
    assert ties.sum() == 2 and flips.sum() <= ties.sum()
    assert np.abs(solver.test_matrix - want).sum() == 2 * flips.sum()
