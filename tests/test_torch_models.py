"""gmfnet and its blocks: flax weights converted into the port give the
same logits as the JAX package, in float32 on both sides.

Tolerance 1e-4 (abs and rel): XLA and oneDNN sum convolutions in
different orders.  In bfloat16 compute the two packages round
independently: on the CPU each lands 0.009-0.015 (max abs) from the f32
logits and 0.009-0.012 from the other, at logits of scale about 1, so the
bf16 parity test holds them within 0.04.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.models import build_model as jax_build_model
from dmfusion.models import common as jcommon
from dmfusion.models.registry import available_models as jax_available_models
from dmfusion_torch.config import load_config
from dmfusion_torch.models import available_models, build_model, model_arity
from dmfusion_torch.models import common as tcommon
from dmfusion_torch.models.convert import (load_flax_params, params_from_flax,
                                           params_to_flax)

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 0.04


def _tree(params):
    return jax.tree.map(np.asarray, serialization.to_state_dict(params))


def _inputs(b=6, ps=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((b, ps, ps, 4), dtype=np.float32),
            rng.random((b, 4 * ps, 4 * ps, 1), dtype=np.float32))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("pan", ["s2d", "pyramid"])
@pytest.mark.parametrize("act", ["Relu", "Gelu"])
def test_gmfnet_logits_match(pan, act):
    over = {"data_city": "synth64", "patch_size": 8, "model_width": 16,
            "seed": 0, "gmfnet_pan": pan, "schedule": {"activate": act},
            "precision": {"compute_dtype": "float32"}}
    jm = jax_build_model(jax_load_config(overrides=over))
    ms, pan_w = _inputs()
    params = jm.init(jax.random.PRNGKey(3), ms, pan_w)["params"]
    want = np.asarray(jm.apply({"params": params}, ms, pan_w))
    tm = load_flax_params(build_model(load_config(overrides=over)),
                          _tree(params)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(ms), torch.from_numpy(pan_w)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    # And back: the torch params map onto the same flax tree exactly.
    back = params_to_flax(tm)
    assert jax.tree.all(jax.tree.map(np.array_equal, _tree(params), back))


@pytest.mark.parametrize("pan,act", [("s2d", "Relu"), ("pyramid", "Gelu")])
def test_gmfnet_bf16_logits_match(pan, act):
    """bf16 compute, f32 params: the port under autocast against flax with
    ``dtype=bfloat16``, the same converted weights."""
    over = {"data_city": "synth64", "patch_size": 8, "model_width": 16,
            "seed": 0, "gmfnet_pan": pan, "schedule": {"activate": act},
            "precision": {"compute_dtype": "bfloat16"}}
    jm = jax_build_model(jax_load_config(overrides=over))
    ms, pan_w = _inputs(b=16)
    params = jm.init(jax.random.PRNGKey(3), ms, pan_w)["params"]
    want = np.asarray(jm.apply({"params": params}, ms, pan_w))
    tm = load_flax_params(build_model(load_config(overrides=over)),
                          _tree(params)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(ms), torch.from_numpy(pan_w))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_norm_output_keeps_compute_dtype(monkeypatch):
    """flax GroupNorm(dtype=bf16) returns bf16, so the activations and the
    residual add after it run in bf16; CUDA autocast's float32 group_norm,
    imitated here, must not widen them."""
    f32_norm = torch.nn.functional.group_norm
    monkeypatch.setattr(torch.nn.functional, "group_norm",
                        lambda x, *a, **k: f32_norm(x.float(), *a, **k))
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 8)
                                                 ).astype(np.float32)
    for jblock, tblock in ((jcommon.ConvBlock(8), tcommon.ConvBlock(8, 8)),
                           (jcommon.ResBlock(16, 2), tcommon.ResBlock(8, 16, 2))):
        p = _block_params(jblock, x)
        assert jblock.apply({"params": p}, x).dtype == jnp.bfloat16
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            assert tblock(_nchw(x)).dtype == torch.bfloat16
    with torch.no_grad():
        assert tblock(_nchw(x)).dtype == torch.float32


def _block_params(module, x):
    return module.init(jax.random.PRNGKey(0), x)["params"]


def _load(tmod, tree, table):
    """Copy a one-level flax block tree into a torch block by name table."""
    state = {}
    for fname, tname in table.items():
        for leaf, arr in tree[fname].items():
            t = torch.from_numpy(np.array(arr))
            if leaf == "kernel":
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            state[f"{tname}.{'bias' if leaf == 'bias' else 'weight'}"] = t
    tmod.load_state_dict(state, strict=True)
    return tmod


@pytest.mark.parametrize("size", [16, 15])
def test_stride2_same_pad(size):
    """flax SAME on a stride-2 3x3 conv pads (0, 1) on an even size and
    (1, 1) on an odd one; symmetric padding=1 would shift the grid."""
    x = np.random.default_rng(0).standard_normal((2, size, size, 3)
                                                 ).astype(np.float32)
    jconv = nn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
    p = _block_params(jconv, x)
    want = np.asarray(jconv.apply({"params": p}, x))
    tconv = tcommon.SameConv2d(3, 5, 3, 2)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.array(p["kernel"])
                                            ).permute(3, 2, 0, 1))
        tconv.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        got = _nhwc(tconv(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)
    if size % 2 == 0:
        sym = torch.nn.functional.conv2d(_nchw(x), tconv.weight, tconv.bias,
                                         2, 1)
        assert not np.allclose(_nhwc(sym), want, **TOL)


@pytest.mark.parametrize("features", [6, 12, 3])
def test_convblock_groupnorm_eps_and_groups(features):
    """ConvBlock: divisor-loop group count and eps 1e-6 (inputs scaled so
    that the eps matters at this tolerance)."""
    x = (1e-3 * np.random.default_rng(1).standard_normal((2, 8, 8, 4))
         ).astype(np.float32)
    jblock = jcommon.ConvBlock(features, dtype=jnp.float32)
    p = _block_params(jblock, x)
    want = np.asarray(jblock.apply({"params": p}, x))
    tblock = _load(tcommon.ConvBlock(4, features), p,
                   {"Conv_0": "conv", "GroupNorm_0": "norm"})
    assert tblock.norm.num_groups == {6: 6, 12: 6, 3: 3}[features]
    assert tblock.norm.eps == 1e-6
    with torch.no_grad():
        got = _nhwc(tblock(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("in_f,features,stride", [(8, 16, 2), (16, 16, 1)])
def test_resblock_matches(in_f, features, stride):
    """ResBlock: min(8, features) groups in its second norm, the 1x1
    stride-2 shortcut with no pad, and the stride-2 SAME pad inside."""
    x = np.random.default_rng(2).standard_normal((2, 8, 8, in_f)
                                                 ).astype(np.float32)
    jblock = jcommon.ResBlock(features, stride, dtype=jnp.float32)
    p = _block_params(jblock, x)
    want = np.asarray(jblock.apply({"params": p}, x))
    tblock = tcommon.ResBlock(in_f, features, stride)
    state = params_from_flax({"ResBlock_0": p})
    tblock.load_state_dict({k.removeprefix("ms_res."): v
                            for k, v in state.items()}, strict=True)
    assert tblock.norm.num_groups == 8
    with torch.no_grad():
        got = _nhwc(tblock(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_space_to_depth_channel_order():
    """Channels come out (dy, dx, c), as the flax reshape orders them,
    which is not pixel_unshuffle's (c, dy, dx) once C > 1."""
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    b, h4, w4, c = x.shape
    want = x.reshape(b, h4 // 4, 4, w4 // 4, 4, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, h4 // 4, w4 // 4, 16 * c)
    got = _nhwc(tcommon.space_to_depth4(_nchw(x)))
    np.testing.assert_array_equal(got, want)
    unshuffled = _nhwc(torch.nn.functional.pixel_unshuffle(_nchw(x), 4))
    assert not np.array_equal(unshuffled, want)


def test_mlp_head_last_dense_runs_f32_under_autocast():
    head = tcommon.MLPHead(8, 3, hidden=4)
    x = torch.randn(2, 8, 2, 2)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = head(x)
    assert out.dtype == torch.float32


def test_gelu_is_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    act = tcommon.activation_fn({"schedule": {"activate": "Gelu"}})
    np.testing.assert_allclose(act(torch.from_numpy(x)).numpy(),
                               np.asarray(nn.gelu(x)), atol=1e-6)


def test_converter_raises_on_unmatched():
    over = {"data_city": "synth64", "patch_size": 8, "model_width": 16}
    jm = jax_build_model(jax_load_config(overrides=over))
    ms, pan_w = _inputs(b=1)
    tree = _tree(jm.init(jax.random.PRNGKey(0), ms, pan_w)["params"])
    model = build_model(load_config(overrides=over))
    extra = {**tree, "Extra_0": {"kernel": np.zeros((1, 1))}}
    with pytest.raises(ValueError, match="left unused"):
        load_flax_params(model, extra)
    missing = {k: v for k, v in tree.items() if k != "fusion_gate"}
    with pytest.raises(ValueError, match="left unset"):
        load_flax_params(model, missing)


def test_registry():
    """The port knows dmfusion's whole zoo, and ``vit`` besides; a name
    neither package knows is refused with the list."""
    assert available_models() == sorted(jax_available_models() + ["vit"])
    assert model_arity("gmfnet") == "dual" and model_arity("dqtl") == "quad"
    assert model_arity("generator") == model_arity("discriminator") == "image"
    assert model_arity("gmfnet_conv") == "dual"
    assert model_arity("dense_fusion") == "dense"
    assert model_arity("tri_net") == "tri"
    for name in ("swin_transformer", "swin_T_dual", "ct_lstm"):
        assert model_arity(name) == "dual"
    with pytest.raises(ValueError, match="unknown model 'nope'.*gmfnet"):
        build_model({"model_name": "nope"})
