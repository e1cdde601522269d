"""The port's IHS ops (``dmfusion_torch/ops/ihs.py``) and the tri arity's
MSPAN scene against dmfusion's, on the CPU in float32.

Exact throughout where the unpooling offsets are shared: the test draws
them as ``dmfusion/ops/ihs.py::unpooling`` does (two ``randint`` from the
split key) and hands them to the port through its one offset function,
``unpool_offsets``.  With the port's own seeded offsets (a CPU
``torch.Generator``), MSPAN differs from dmfusion's only by rounding:
its band mean equals PAN in exact arithmetic, and both lie within 1e-5 of
the normalised, padded PAN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import prep_scene as jax_prep_scene
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.ops import ihs as jax_ihs
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import mspan_scene, prep_scene, synthetic_scene
from dmfusion_torch.ops import ihs

OVER = {"data_city": "synth64", "patch_size": 8, "seed": 0}


def _jax_offsets(key, shape, t):
    """dmfusion's unpooling offsets, drawn as ``ihs.py:66-68`` draws them."""
    km, kn = jax.random.split(key)
    m = jax.random.randint(km, shape, 0, t)
    n = jax.random.randint(kn, shape, 0, t)
    return (torch.from_numpy(np.asarray(m, np.uint8)),
            torch.from_numpy(np.asarray(n, np.uint8)))


@pytest.fixture
def jax_offsets(monkeypatch):
    """Route the port's offsets through JAX's draw for ``key``."""
    def use(key):
        monkeypatch.setattr(ihs, "unpool_offsets",
                            lambda shape, t, generator: _jax_offsets(
                                key, shape, t))
    return use


@pytest.mark.parametrize("scale,shape", [(2, (16, 20)), (3, (17, 23)),
                                         (4, (32, 36))])
def test_block_mean_bit_equal(rng, scale, shape):
    img = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_ihs.block_mean(jnp.asarray(img), scale))
    got = ihs.block_mean(torch.from_numpy(img), scale).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_pan2ms_bit_equal(rng):
    h, w, c = 6, 7, 4
    pan = rng.standard_normal((4 * h, 4 * w)).astype(np.float32)
    want = np.asarray(jax_ihs.pan2ms(jnp.asarray(pan), (h, w, c)))
    got = ihs.pan2ms(torch.from_numpy(pan), (h, w, c)).numpy()
    assert got.shape == (h, w, c) and np.array_equal(got, want)


def test_unpooling_bit_equal(rng, jax_offsets):
    x = rng.standard_normal((5, 7, 4)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jax_offsets(key)
    want = np.asarray(jax_ihs.unpooling(jnp.asarray(x), 4, key))
    got = ihs.unpooling(torch.from_numpy(x), 4, None).numpy()
    assert got.shape == (20, 28, 4) and np.array_equal(got, want)
    # Each 4x4 block holds its value once, the rest zeros.
    blocks = got.reshape(5, 4, 7, 4, 4)
    assert ((blocks != 0).sum(axis=(1, 3)) == 1).all()
    assert np.array_equal(blocks.sum(axis=(1, 3)), x)


def test_replicate_and_upsample_equal(rng):
    x = rng.standard_normal((3, 5)).astype(np.float32)
    assert np.array_equal(
        ihs.replicate_channels(torch.from_numpy(x), 4).numpy(),
        np.asarray(jax_ihs.replicate_channels(jnp.asarray(x), 4)))
    assert np.array_equal(
        ihs.upsample_nearest(torch.from_numpy(x), 3).numpy(),
        np.asarray(jax_ihs.upsample_nearest(jnp.asarray(x), 3)))


def test_ihs_transform_and_prep_equal_with_jax_offsets(jax_offsets):
    """The synth64 scene's MSPAN, as dmfusion's solver builds it
    (``ihs_transform`` keyed by ``PRNGKey(seed)``, then ``prep_scene`` at
    4 x patch), and as the port's ``mspan_scene`` builds it with the same
    offsets: bit-equal."""
    jcfg = jax_load_config(overrides=OVER)
    jscene = jax_synthetic_scene(jcfg)
    key = jax.random.PRNGKey(int(jcfg["seed"]))
    raw = jax_ihs.ihs_transform(jnp.asarray(jscene.raw_ms, jnp.float32),
                                jnp.asarray(jscene.raw_pan, jnp.float32), key)
    want = np.asarray(jax_prep_scene(raw, 4 * jscene.patch, raw.dtype))

    jax_offsets(key)
    tscene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    got_raw = ihs.ihs_transform(torch.from_numpy(tscene.raw_ms),
                                torch.from_numpy(tscene.raw_pan), None)
    assert np.array_equal(got_raw.numpy(), np.asarray(raw))
    got = mspan_scene(tscene, jcfg["seed"])
    assert got.dtype == torch.float32 and got.shape == tscene.pan.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(prep_scene(got_raw, 4 * tscene.patch,
                                     torch.float32).numpy(), want)


def test_own_offsets_seeded_and_near_pan():
    """The port's own draw: one seed gives one MSPAN, another seed another;
    each within 1e-5 of the normalised, padded PAN (they are equal in
    exact arithmetic)."""
    tscene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    a = mspan_scene(tscene, 0)
    b = mspan_scene(tscene, 0)
    c = mspan_scene(tscene, 1)
    assert torch.equal(a, b)
    assert not torch.equal(ihs.unpooling(torch.ones(4, 4, 4), 4,
                                         torch.Generator().manual_seed(0)),
                           ihs.unpooling(torch.ones(4, 4, 4), 4,
                                         torch.Generator().manual_seed(1)))
    for m in (a, c):
        assert float((m - tscene.pan).abs().max()) <= 1e-5
    m, n = ihs.unpool_offsets((3, 4, 4), 4, torch.Generator().manual_seed(0))
    assert m.dtype == n.dtype == torch.uint8 and int(m.max()) < 4


def test_ihs_transform_collapses_to_pan(rng):
    """``tests/test_scene_ops.py``'s identity on the port: the band mean of
    (MS_up + delta) equals PAN."""
    ms = rng.random((4, 5, 4)).astype(np.float32)
    pan = rng.random((16, 20)).astype(np.float32)
    got = ihs.ihs_transform(torch.from_numpy(ms), torch.from_numpy(pan),
                            torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_allclose(got, pan, atol=1e-5)
