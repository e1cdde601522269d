"""The port's losses against dmfusion's, on the same numpy-seeded inputs,
masked and unmasked, in float32.

Tolerances: atol 1e-6 for every loss; rtol 1e-5 (and atol 1e-6) for
``qua_loss``, whose sums of six KL terms round in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmfusion.config import load_config as jax_load_config
from dmfusion.train import losses as jl
from dmfusion_torch.train import losses as tl

ATOL = 1e-6


def _arrays(seed, b=24, c=7):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, c))).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    mask = (np.arange(b) < b - 5).astype(np.float32)  # a padded tail
    return logits, labels, mask


def _close(got, want, **tol):
    np.testing.assert_allclose(float(got), float(want), **(tol or
                                                           {"atol": ATOL}))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cross_entropy(seed, masked):
    logits, labels, mask = _arrays(seed)
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), m_j)
    got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           m_t)
    _close(got, want)


def test_cross_entropy_all_masked_is_zero():
    """max(m.sum(), 1): a batch of padding only gives 0, not NaN."""
    logits, labels, _ = _arrays(2)
    zero = np.zeros(len(labels), np.float32)
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(zero))
    got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(zero))
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("name", ["mse", "l1"])
def test_mse_l1(name):
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((6, 5, 4)).astype(np.float32) for _ in "ab")
    want = getattr(jl, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want)


def _probs(rng, shape, zeros=False):
    p = rng.random(shape).astype(np.float32)
    if zeros:  # exact zeros exercise 0 log 0 := 0
        p[:, ::3] = 0
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("zeros", [False, True])
def test_kl(zeros):
    rng = np.random.default_rng(4)
    log_pred = np.log(_probs(rng, (9, 6))).astype(np.float32)
    target = _probs(rng, (9, 6), zeros)
    want = jl.kl(jnp.asarray(log_pred), jnp.asarray(target))
    got = tl.kl(torch.from_numpy(log_pred), torch.from_numpy(target))
    _close(got, want)


@pytest.mark.parametrize("zeros", [False, True])
def test_kl_batchmean_weighted(zeros):
    rng = np.random.default_rng(5)
    log_pred = np.log(_probs(rng, (8, 5))).astype(np.float32)
    target = _probs(rng, (8, 5), zeros)
    w = np.array([1, 1, 0, 1, 0, 1, 1, 0], np.float32)
    want = jl._kl_batchmean(jnp.asarray(log_pred), jnp.asarray(target),
                            jnp.asarray(w))
    got = tl._kl_batchmean(torch.from_numpy(log_pred),
                           torch.from_numpy(target), torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dqtl", [
    {},                                    # the defaults: beta 0
    {"alpha": 0.3, "beta": 0.5, "gamma": 0.7},
    {"alpha": 0.0, "beta": 0.2, "gamma": 1.0}])
def test_qua_loss(dqtl, masked):
    cfg = jax_load_config(overrides={"dqtl": dqtl})
    bs = 6
    rng = np.random.default_rng(6)
    out = (2 * rng.standard_normal((4 * bs, 5))).astype(np.float32)
    targets = rng.integers(0, 5, bs).astype(np.int32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    want = jl.qua_loss(jnp.asarray(out), bs, jnp.asarray(targets), cfg,
                       jnp.asarray(mask) if masked else None)
    got = tl.qua_loss(torch.from_numpy(out), bs, torch.from_numpy(targets),
                      cfg, torch.from_numpy(mask) if masked else None)
    _close(got, want, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("name", ["MSE", "L1", "Criterion", "KL",
                                  "qua_loss"])
def test_make_loss_picks_the_same_loss(name):
    cfg = jax_load_config()
    j, t = jl.make_loss(name, cfg), tl.make_loss(name, cfg)
    if name == "qua_loss":
        rng = np.random.default_rng(7)
        out = rng.standard_normal((8, 4)).astype(np.float32)
        tg = rng.integers(0, 4, 2).astype(np.int32)
        _close(t(torch.from_numpy(out), 2, torch.from_numpy(tg)),
               j(jnp.asarray(out), 2, jnp.asarray(tg)), rtol=1e-5, atol=ATOL)
    else:
        assert t.__name__ == j.__name__


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        tl.make_loss("Nope", {})
