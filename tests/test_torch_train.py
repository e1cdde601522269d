"""``DualPrograms``: the port's train, eval and predict programs against
dmfusion's, from the same converted weights on the same numpy batches, in
float32 on the CPU (synth64, patch 8, width 8, batch 32), at seeds 0, 1
and 2.

An epoch is 3 steps, the last a partial batch with its padding masked.
The first epoch runs freely in both packages from the same converted
initial state.  In the second, each step of the port starts from JAX's
parameters and optax state before that step, carried across by the
converter, and is held against JAX's step; JAX's gradient is read from
its first moment.  Tolerances, with the largest readings over the three
seeds:
  * per-step losses: atol 1e-5 (1.8e-6 in epoch 1, 2.4e-7 in epoch 2);
  * Adam moments and the update count: atol 1e-5 (3.6e-7, 4.5e-8);
  * epoch 1's parameters: atol 1e-5 wherever every step's gradient was
    at least ``TINY_GRAD`` (1.6e-6).  Adam's step is
    ``lr * m / (sqrt(v) + eps)``: where a gradient is within rounding of
    0, XLA's and oneDNN's sums decide its sign, and the step is lr-sized
    either way.  At width 8 that is 4-7 % of the elements, chiefly the
    conv biases before a GroupNorm with one channel per group, whose
    gradient is exactly 0 in exact arithmetic; those are held to Adam's
    step bound, ``2 * lr`` a step (3.7e-3 over 3 steps);
  * epoch 2's gradients: atol ``GRAD_ATOL`` (4.5e-7), except at a step
    where a ReLU input of the port's forward lies within ``KINK`` of 0.
    There float32 rounding decides whether the unit passes its gradient
    on, and the two packages may decide it differently: the forward and
    the loss agree, but the gradients of the weights upstream of that
    unit move.  Seed 1 meets this at epoch 2's first step: a ReLU input
    at 1.5e-7, gradients apart by up to 2.5e-3.  Seed 0 has an input at 9.5e-7 at its second step,
    which both packages take to the same side;
  * epoch 2's parameters: atol 1e-5 (4.3e-7) except where the gradient
    is tiny or the two gradients part by more than ``GRAD_REL`` of JAX's:
    3-8 % of the elements at a step without a kink, 42 % at seed 1's
    kink, held to Adam's step bound (9.5e-4).  At a kink the moments are
    held to 1e-5 plus their decay's share of the gradients' gap;
  * ``eval_epoch``'s loss sum: rtol 1e-5; confusions, ``predict`` and
    ``test_confusion``: equal.  The test asserts that no eval anchor's
    top-two logits lie within 1e-4 (the smallest gap is 9.8e-4), so no
    argmax can flip on rounding.

Run freely, the second epochs of seeds 0 and 1 meet such a step, and the
two packages' losses then part by more than 1e-5 within two steps: why
the second epoch is held step by step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data import synthetic_scene as jax_synthetic_scene
from dmfusion.models import build_model as jax_build_model
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import DualPrograms as JaxDualPrograms
from dmfusion_torch.config import load_config
from dmfusion_torch.data.patches import batched_ids_np
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           opt_state_to_optax, params_to_flax)
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import DualPrograms

OVER = {"data_city": "synth64", "patch_size": 8, "batchsize": 32,
        "test_batchsize": 32, "color_batchsize": 32, "epoch": 2, "time": 1,
        "train_rate": 0.05, "verify_rate": 0.05, "seed": 0, "model_width": 8,
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
LR = 1e-3
BETA1, BETA2 = 0.9, 0.999  # optax.adam's decays
STEPS = 3
TINY_GRAD = 1e-7
GRAD_ATOL = 1e-5
GRAD_REL = 1e-3
KINK = 1e-6
SEEDS = (0, 1, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


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


def _batches(label, rng, n):
    labeled = np.flatnonzero(label.reshape(-1) != 0).astype(np.int32)
    ids = rng.choice(labeled, n, replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids, 32)
    labels = label.reshape(-1)[chunks].astype(np.int32)
    return chunks, labels, mask.astype(np.float32)


def _watch_activations(model):
    """Record, per forward, the smallest |input| of any activation."""
    seen = []

    def watch(act):
        def wrapped(x):
            seen[-1] = min(seen[-1], float(x.detach().abs().min()))
            return act(x)
        return wrapped

    for m in model.modules():
        if hasattr(m, "act"):
            m.act = watch(m.act)
    return seen


@pytest.fixture(scope="module", params=SEEDS)
def run(request):
    """Both packages: epoch 1 from the same weights; epoch 2 step by step,
    the port's every step from JAX's state before it; eval, predict and
    test on JAX's epoch-1 weights."""
    seed = request.param
    jcfg, tcfg = jax_load_config(overrides=OVER), load_config(overrides=OVER)
    jscene = jax_synthetic_scene(jcfg)
    tscene = synthetic_scene(tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    ep1 = _batches(jscene.label, rng, 80)   # 32 + 32 + 16 real, 16 padded
    ep2 = _batches(jscene.label, rng, 80)
    evb = _batches(jscene.label, rng, 90)

    jprog = JaxDualPrograms(jax_build_model(jcfg),
                            jax_make_optimizer(jcfg, STEPS), jcfg,
                            jscene.width, jscene.patch)
    jargs = (jscene.ms, jscene.pan)
    # train_epoch donates its inputs: keep host copies of every state.
    p, o = jprog.init(jax.random.PRNGKey(seed))
    p0, o0 = _tree(p), _tree(o)
    p, o, jl1 = jprog.train_epoch(p, o, jargs, *map(jnp.asarray, ep1))
    p1, o1 = _tree(p), _tree(o)
    jp1 = serialization.from_state_dict(p, p1)
    jsteps = []  # (state before, state after, loss) of epoch 2's steps
    for i in range(STEPS):
        before = (_tree(p), _tree(o))
        p, o, jl = jprog.train_epoch(
            p, o, jargs, *(jnp.asarray(a[i:i + 1]) for a in ep2))
        jsteps.append((before, (_tree(p), _tree(o)), float(jl[0])))
    jax_eval = jprog.eval_epoch(jp1, jargs, *map(jnp.asarray, evb))
    ms_b, pan_b = jprog._gather(jargs, jnp.asarray(evb[0].reshape(-1)))
    jax_logits = np.asarray(jprog.apply(jp1, ms_b, pan_b))

    targs = (tscene.ms, tscene.pan)

    def port(params, opt_state, batches, steps):
        model = load_flax_params(build_model(tcfg), params)
        opt = make_optimizer(tcfg, model.parameters(), STEPS)
        opt_state_from_optax(opt_state, model, opt)
        prog = DualPrograms(model, opt, tcfg, tscene.width, tscene.patch)
        seen = _watch_activations(model)
        ids, labels, mask = map(torch.from_numpy, batches)
        losses, grads = [], []
        # One step per call, so each step's gradient can be read back.
        for i in steps:
            seen.append(float("inf"))
            losses.append(prog.train_epoch(targs, ids[i:i + 1],
                                           labels[i:i + 1], mask[i:i + 1]))
            grads.append(_vec(params_to_flax(
                model, {n: p.grad for n, p in model.named_parameters()})))
        return {"prog": prog, "losses": torch.cat(losses).numpy(),
                "grads": grads, "near_zero": seen}

    t1 = port(p0, o0, ep1, range(STEPS))
    t2 = [port(*before, ep2, [i]) for i, (before, _, _) in enumerate(jsteps)]
    return {"seed": seed, "jax1": (p1, o1, np.asarray(jl1)), "jsteps": jsteps,
            "port1": t1, "port2": t2, "eval": (evb, jax_eval, jax_logits),
            "jprog": jprog, "jargs": jargs, "jp1": jp1, "tcfg": tcfg,
            "tscene": tscene}


def _epoch2_step(run, i):
    """Step ``i`` of epoch 2: the port's and JAX's params, moments and
    gradients after it (flax layout, one vector each), and whether the
    port's forward met a ReLU kink."""
    (_, o0), (params, opt_state), _ = run["jsteps"][i]
    t = run["port2"][i]
    prog = t["prog"]
    got_o = opt_state_to_optax(prog.model, prog.optimizer)
    mu0 = _vec(o0["0"]["mu"])
    mu = _vec(opt_state["0"]["mu"])
    return {"params": (_vec(params_to_flax(prog.model)), _vec(params)),
            "mu": (_vec(got_o["0"]["mu"]), mu),
            "nu": (_vec(got_o["0"]["nu"]), _vec(opt_state["0"]["nu"])),
            "count": (int(got_o["0"]["count"]), int(opt_state["0"]["count"])),
            # optax's mu is BETA1 * mu0 + (1 - BETA1) * g: JAX's gradient.
            "grad": (t["grads"][0], (mu - BETA1 * mu0) / (1 - BETA1)),
            "kink": t["near_zero"][0] < KINK}


def test_epoch2_gradients_differ_only_at_relu_kinks(run):
    parted = []
    for i in range(STEPS):
        step = _epoch2_step(run, i)
        got, want = step["grad"]
        gap = np.abs(got - want).max()
        assert gap <= GRAD_ATOL or step["kink"], (i, gap)
        parted.append(gap > GRAD_ATOL)
    # Seed 1's first step of epoch 2 is the case the exception is for.
    assert any(parted) == (run["seed"] == 1)


@pytest.mark.parametrize("epoch", [0, 1])
def test_epoch_losses(run, epoch):
    if epoch == 0:
        want, got = run["jax1"][2], run["port1"]["losses"]
    else:
        want = np.array([loss for _, _, loss in run["jsteps"]])
        got = np.concatenate([t["losses"] for t in run["port2"]])
    assert got.shape == want.shape == (STEPS,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("epoch", [0, 1])
def test_epoch_params(run, epoch):
    if epoch == 0:
        params, _, _ = run["jax1"]
        t = run["port1"]
        got, want = _vec(params_to_flax(t["prog"].model)), _vec(params)
        tiny = np.min(np.abs(t["grads"]), axis=0) < TINY_GRAD
        assert tiny.mean() < 0.1, f"{tiny.mean():.3f} of gradients are tiny"
        cases = [(got, want, tiny, STEPS)]
    else:
        cases = []
        for i in range(STEPS):
            step = _epoch2_step(run, i)
            g, jg = step["grad"]
            excused = ((np.abs(g) < TINY_GRAD)
                       | (np.abs(g - jg) > GRAD_REL * np.abs(jg)))
            assert step["kink"] or excused.mean() < 0.1
            cases.append((*step["params"], excused, 1))
    for got, want, excused, steps in cases:
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff[~excused].max() <= 1e-5, diff[~excused].max()
        assert diff[excused].max(initial=0) <= 2 * LR * steps


@pytest.mark.parametrize("epoch", [0, 1])
def test_epoch_adam_moments(run, epoch):
    if epoch == 0:
        _, want, _ = run["jax1"]
        prog = run["port1"]["prog"]
        got = opt_state_to_optax(prog.model, prog.optimizer)
        assert int(got["0"]["count"]) == int(want["0"]["count"]) == STEPS
        for key in ("mu", "nu"):
            np.testing.assert_allclose(_vec(got["0"][key]),
                                       _vec(want["0"][key]), rtol=0,
                                       atol=1e-5, err_msg=key)
        return
    for i in range(STEPS):
        step = _epoch2_step(run, i)
        assert step["count"] == (STEPS + i + 1,) * 2
        g, jg = step["grad"]
        # Moments of two gradients that part at a kink part by their
        # decay's share of the gap; elsewhere that share is under 1e-6.
        for key, share in (("mu", (1 - BETA1) * np.abs(g - jg)),
                           ("nu", (1 - BETA2) * np.abs(g * g - jg * jg))):
            got, want = step[key]
            assert (np.abs(got - want) <= 1e-5 + share).all(), (key, i)


@pytest.fixture(scope="module")
def port_eval(run):
    """The port's programs holding JAX's epoch-1 weights."""
    p1 = run["jax1"][0]
    tcfg, tscene = run["tcfg"], run["tscene"]
    model = load_flax_params(build_model(tcfg), p1)
    return DualPrograms(model, None, tcfg, tscene.width, tscene.patch)


def test_no_near_ties(run):
    logits = run["eval"][2]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= 1e-4


def test_eval_epoch(run, port_eval):
    evb, (jloss, jconf), _ = run["eval"]
    targs = (run["tscene"].ms, run["tscene"].pan)
    loss, conf = port_eval.eval_epoch(targs, *map(torch.from_numpy, evb))
    assert loss.dtype == conf.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert np.array_equal(conf.numpy(), np.asarray(jconf))
    assert conf.sum() == 90  # the padding is masked out


def test_predict_and_test_confusion(run, port_eval):
    evb, (_, jconf), _ = run["eval"]
    targs = (run["tscene"].ms, run["tscene"].pan)
    ids = torch.from_numpy(evb[0])
    got = port_eval.predict(targs, ids)
    want = np.asarray(run["jprog"].predict(run["jp1"], run["jargs"],
                                           jnp.asarray(evb[0])))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    conf = port_eval.test_confusion(targs, *map(torch.from_numpy, evb))
    assert np.array_equal(conf.numpy(), np.asarray(jconf))
    assert port_eval.supports_map is False


def test_eval_scan_anchors_knob(run):
    tcfg, tscene = run["tcfg"], run["tscene"]
    model = build_model(tcfg)
    targs = (tscene.ms, tscene.pan)
    ids = torch.zeros((1, 32), dtype=torch.int32)
    for v in ("auto", "off", 4096):
        prog = DualPrograms(model, None, {**tcfg, "eval_scan_anchors": v},
                            tscene.width, tscene.patch)
        assert prog.predict(targs, ids).shape == (1, 32)
    with pytest.raises(ValueError, match="eval_scan_anchors"):
        DualPrograms(model, None, {**tcfg, "eval_scan_anchors": "lots"},
                     tscene.width, tscene.patch)


def test_init_is_seeded(run):
    tcfg, tscene = run["tcfg"], run["tscene"]
    outs = []
    for _ in range(2):
        model = build_model(tcfg)
        opt = make_optimizer(tcfg, model.parameters(), 1)
        prog = DualPrograms(model, opt, tcfg, tscene.width, tscene.patch)
        prog.init(torch.Generator().manual_seed(5))
        outs.append(params_to_flax(model))
        assert opt.param_groups[0]["count"] == 0
    assert jax.tree.all(jax.tree.map(np.array_equal, *outs))
