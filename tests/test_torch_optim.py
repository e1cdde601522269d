"""The port's schedules, optimizers and optimizer-state converter against
dmfusion's optax ones.

  * Schedules: dmfusion's evaluated on jnp int32 counts, as optax calls
    them, against the port's on the same counts, at steps_per_epoch 1 and
    3; rtol 1e-6.
  * Optimizers: five updates from the same parameters and gradients, with
    the schedule off and on; rtol 1e-6, and atol 1e-8 (a float32 ulp of
    an update) for elements near 0.  Adam takes atol 1e-6: optax computes
    its bias correction ``1 - 0.999 ** t`` in float32 (1.3e-5 off the
    exact value at t = 1), torch in float64, so each lr-sized update (lr
    1e-2) differs by about 1e-5 of itself.  RMSprop is also run at
    gradients near 1e-5, where eps inside the root (optax) and outside it
    (``torch.optim.RMSprop``) differ tenfold.
  * The converter: an optax state of gmfnet goes into the port and back
    unchanged, and one more update from it gives the same parameters
    (atol 1e-6: RMSprop's rsqrt of a small ``nu`` rounds a few ulps apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.models import build_model as jax_build_model
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.optim import make_schedule as jax_make_schedule
from dmfusion_torch.config import load_config
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           opt_state_to_optax, params_to_flax)
from dmfusion_torch.train.optim import make_optimizer, make_schedule

SCHEDULES = ["StepLR", "LinearLR", "CosineAnnealingLR", "CyclicLR",
             "OneCycleLR", "ConstantLR", "ChainedScheduler", "ExponentialLR"]


def _cfg(optimizer="ADAM", scheduler=None, epochs=50):
    return {"schedule": {"loss": "Criterion", "optimizer": optimizer,
                         "if_scheduler": int(scheduler is not None),
                         "scheduler": scheduler or "ExponentialLR",
                         "activate": "Relu", "lr": 1e-2, "base_lr": 1e-3,
                         "momentum": 0.9, "alpha": 0.99},
            "epoch": epochs}


@pytest.mark.parametrize("spe", [1, 3])
@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_optax_counts(name, spe):
    cfg = _cfg(scheduler=name)
    want_fn, got_fn = jax_make_schedule(cfg, spe), make_schedule(cfg, spe)
    counts = range(0, 160 * spe, spe if spe == 1 else 2)
    want = [float(want_fn(jnp.asarray(c, jnp.int32))) for c in counts]
    got = [got_fn(c) for c in counts]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=name)


def test_schedule_off_and_unknown():
    assert make_schedule(_cfg(), 4) is None
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_schedule(_cfg(scheduler="Nope"), 1)
    bad = _cfg()
    bad["schedule"]["optimizer"] = "Nope"
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(bad, [torch.nn.Parameter(torch.zeros(2))])


def _run_both(optimizer, scheduler, grad_scale, spe=2, steps=5, seed=0):
    """Five updates in optax and in the port from the same params and
    grads; returns both parameter sets, the port's optimizer, optax's
    state."""
    rng = np.random.default_rng(seed)
    init = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32)}
    grads = [{k: (grad_scale * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in init.items()} for _ in range(steps)]
    cfg = _cfg(optimizer, scheduler)
    tx = jax_make_optimizer(cfg, spe)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = make_optimizer(cfg, list(tp.values()), spe)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return ({k: np.asarray(v) for k, v in jp.items()},
            {k: p.detach().numpy() for k, p in tp.items()}, opt, state)


@pytest.mark.parametrize("scheduler", [None, "ExponentialLR", "CyclicLR"])
@pytest.mark.parametrize("optimizer", ["ADAM", "SGD", "RMSprop"])
def test_five_updates_match_optax(optimizer, scheduler):
    want, got, opt, _ = _run_both(optimizer, scheduler, grad_scale=0.3)
    atol = 1e-6 if optimizer == "ADAM" else 1e-8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=atol,
                                   err_msg=f"{optimizer} {scheduler} {k}")
    assert opt.param_groups[0]["count"] == 5


def test_rmsprop_eps_inside_the_root():
    """Gradients near 1e-5: nu ~ 1e-12 << eps, so eps inside the root
    gives steps of about lr * g / 1e-4 and outside it about lr * g /
    (sqrt(nu) + 1e-8): a tenfold difference that torch's RMSprop shows."""
    want, got, _, _ = _run_both("RMSprop", None, grad_scale=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-8)
    # torch's own RMSprop (eps outside the root) lands far from optax.
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    _ = rng.standard_normal((4,))
    g = (1e-5 * rng.standard_normal((3, 4))).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ref = torch.optim.RMSprop([p], lr=1e-2, alpha=0.99, eps=1e-8)
    p.grad = torch.from_numpy(g)
    ref.step()
    step_torch = np.abs(p.detach().numpy() - w0).mean()
    tx = optax.rmsprop(1e-2, decay=0.99)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(w0)))
    step_optax = float(jnp.abs(upd).mean())
    assert step_torch > 5 * step_optax


def test_count_lives_in_the_state_dict():
    """A resumed optimizer goes on with the schedule: the update count is
    saved and loaded with the state."""
    _, _, opt, _ = _run_both("ADAM", "ExponentialLR", 0.3, spe=1, steps=3)
    sd = opt.state_dict()
    assert sd["param_groups"][0]["count"] == 3
    p = [torch.nn.Parameter(torch.zeros(3, 4)), torch.nn.Parameter(
        torch.zeros(4))]
    fresh = make_optimizer(_cfg("ADAM", "ExponentialLR"), p, 1)
    fresh.load_state_dict(sd)
    for q in p:
        q.grad = torch.ones_like(q)
    fresh.step()
    # The fourth update ran at schedule(3), epoch 3.
    assert fresh.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.98 ** 3,
                                                        rel=1e-6)
    assert fresh.param_groups[0]["count"] == 4


OVER = {"data_city": "synth64", "patch_size": 8, "model_width": 8,
        "seed": 0, "precision": {"compute_dtype": "float32"}}


@pytest.fixture(scope="module")
def gmfnet_params():
    jm = jax_build_model(jax_load_config(overrides=OVER))
    ins = (np.zeros((1, 8, 8, 4), np.float32),
           np.zeros((1, 32, 32, 1), np.float32))
    return jm.init(jax.random.PRNGKey(1), *ins)["params"]


def _tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


@pytest.mark.parametrize("scheduler", [None, "ExponentialLR"])
@pytest.mark.parametrize("optimizer", ["ADAM", "SGD", "RMSprop"])
def test_converter_both_ways(gmfnet_params, optimizer, scheduler):
    """optax state after two updates -> the port -> optax: unchanged; and
    one more update from the converted state matches optax's."""
    cfg = {**jax_load_config(overrides=OVER), **_cfg(optimizer, scheduler)}
    tx = jax_make_optimizer(cfg, 1)
    rng = np.random.default_rng(2)
    params, state = gmfnet_params, tx.init(gmfnet_params)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        0.1 * rng.standard_normal(a.shape), jnp.float32), params)
        for _ in range(3)]
    for g in grads[:2]:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    sd = _tree(state)

    model = load_flax_params(build_model(load_config(overrides=OVER)),
                             _tree(params))
    opt = make_optimizer(cfg, model.parameters(), 1)
    opt_state_from_optax(sd, model, opt, count=2)
    assert opt.param_groups[0]["count"] == 2
    back = opt_state_to_optax(model, opt)
    assert jax.tree.structure(back) == jax.tree.structure(sd)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, sd))
    # optax rebuilds its own state from the converted dict.
    serialization.from_state_dict(state, back)

    upd, _ = tx.update(grads[2], state, params)
    want = _tree(optax.apply_updates(params, upd))
    g_tree = _tree(grads[2])
    g_model = load_flax_params(build_model(load_config(overrides=OVER)),
                               g_tree)
    for p, g in zip(model.parameters(), g_model.parameters()):
        p.grad = g.detach().clone()
    opt.step()
    got = params_to_flax(model)
    # A wrong mapping (moments swapped, a kernel not transposed) moves the
    # update by its own size, about lr = 1e-2.
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, a, rtol=1e-6, atol=1e-6), want, got)


def test_converter_refuses_another_optimizer(gmfnet_params):
    cfg = {**jax_load_config(overrides=OVER), **_cfg("SGD")}
    sd = _tree(jax_make_optimizer(cfg, 1).init(gmfnet_params))
    model = load_flax_params(build_model(load_config(overrides=OVER)),
                             _tree(gmfnet_params))
    adam = make_optimizer({**cfg, **_cfg("ADAM")}, model.parameters(), 1)
    with pytest.raises(ValueError, match="not a Adam state"):
        opt_state_from_optax(sd, model, adam)
