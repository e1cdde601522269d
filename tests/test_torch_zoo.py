"""The dual-arity models of the zoo — resnet18, cross_net,
vision_transformer, swin_transformer, swin_T_dual and ct_lstm — against
dmfusion's, on the CPU in float32 (synth64, patch 8, small widths: depth
1, and two Swin stages of two blocks, so that each runs a shifted block),
and the attention hazards each pinned by a case of its own.  The Swin
models run under Gelu (the tanh form), Swin's own activation; the rest
under ReLU.

Tolerances, with the largest readings:
  * the forward from converted params: atol 1e-5 (resnet18 1.4e-6,
    cross_net 4.8e-7, vision_transformer 5.4e-7, swin_transformer 3.4e-7,
    swin_T_dual 2.4e-7, ct_lstm 5.2e-8);
  * the converter round trip: bit-equal;
  * one Adam step through ``DualPrograms`` from flax's initial state
    (optax's moments start at 0, so the first mu is JAX's gradient times
    ``1 - BETA1``): the loss atol 1e-5; the gradients within ``GRAD_ATOL``
    plus ``GRAD_RTOL`` of their leaf's largest (largest share of that
    tolerance: resnet18 0.33, cross_net 0.030, vision_transformer 0.036,
    swin_transformer 0.020, swin_T_dual 0.053, ct_lstm 0.012),
    and the moments atol 1e-5 against optax's; both everywhere except the
    parameters upstream of a ReLU whose input lies within ``KINK`` of 0
    in the port's forward (a tanh-form Gelu has no kink).  There float32
    rounding decides whether the unit passes its gradient on, and the
    packages may decide it differently: resnet18 (and only it, pinned by
    ``KINKS``) meets one at
    1.8e-8 in its PAN branch's first ResBlock, and the gradients of the
    PAN stem and of that block's first conv part by up to 5.4e-4.  There
    the port's moments are held to its own gradient.  The parameters:
    atol 1e-5 except where the two gradients part by more than
    ``GRAD_REL`` of JAX's (0.5-0.6 % of the elements, under 10 % by
    assertion: gradients that are rounding noise, such as the key biases,
    which the softmax cancels, and the conv biases before a GroupNorm),
    held to Adam's step bound, ``2 * lr``;
  * a dmfusion ``.dmx`` served by the port, its widths read from the
    param tree: dmfusion's predictions, equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.export import load_artifact as jax_load_artifact
from dmfusion.export import save_artifact as jax_save_artifact
from dmfusion.infer import ScenePredictor as JaxScenePredictor
from dmfusion.models import build_model as jax_build_model
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import DualPrograms as JaxDualPrograms
from dmfusion_torch.config import load_config
from dmfusion_torch.data.patches import batched_ids_np
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.export import load_artifact, save_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.models import available_models, build_model, model_arity
from dmfusion_torch.models.attention import MultiHeadAttention
from dmfusion_torch.models.common import LayerNorm, init_params
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           opt_state_to_optax, params_to_flax)
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import DualPrograms

BASE = {"data_city": "synth64", "patch_size": 8, "batchsize": 32, "seed": 0,
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
# Widths off the config's defaults (model_width 64; trans: embed 96,
# depth 2, 3 heads, patch 1), so a .dmx served with the defaults fails.
MODELS = {
    "resnet18": {"model_width": 4},
    "cross_net": {"trans": {"embed_dim": 12, "depth": 1, "num_head": 2,
                            "patch_size": 1}},
    "vision_transformer": {"trans": {"embed_dim": 12, "depth": 1,
                                     "num_head": 2, "patch_size": 2}},
    # Two blocks a stage, so a shifted block runs in each (8x8, then 4x4);
    # Gelu (tanh form), Swin's own activation.
    "swin_transformer": {"trans": {"embed_dim": 12, "window_size": 2,
                                   "depths": [2, 2], "num_heads": [2, 2]},
                         "schedule": {"activate": "Gelu"}},
    "swin_T_dual": {"trans": {"embed_dim": 12, "window_size": 2,
                              "depths": [2, 2], "num_heads": [2, 2]},
                    "schedule": {"activate": "Gelu"}},
    "ct_lstm": {"model_width": 8},
}
LR, GRAD_ATOL, GRAD_RTOL, GRAD_REL, KINK = 1e-3, 1e-5, 1e-4, 1e-3, 1e-6
# The activations whose input lies within KINK of 0 in the Adam step, by
# model: resnet18's PAN ResBlock_0 first unit, at 1.8e-8.
KINKS = {"resnet18": ["pan_branch.blocks.0.block"]}
BETA1, BETA2 = 0.9, 0.999  # optax.adam's decays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(name):
    return {**BASE, "model_name": name, **MODELS[name]}


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


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 8, 8, 4), dtype=np.float32),
            rng.random((b, 32, 32, 1), dtype=np.float32))


@pytest.fixture(scope="module", params=sorted(MODELS))
def zoo(request):
    name = request.param
    over = _over(name)
    jcfg = jax_load_config(overrides=over)
    jm = jax_build_model(jcfg)
    # Jitted: one compile, where eager init compiles op by op.
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              *map(jnp.asarray, _inputs(1)))
    return {"name": name, "over": over, "jcfg": jcfg, "jm": jm,
            "params": params["params"], "tree": _tree(params["params"])}


def test_registry():
    assert {"resnet18", "cross_net", "vision_transformer", "vit",
            "tri_net"} <= set(available_models())
    for name in MODELS:
        assert model_arity(name) == "dual"
    cfg = load_config(overrides=_over("vision_transformer"))
    assert type(build_model(cfg)) is type(build_model(cfg, "vit"))


def test_forward_matches_flax(zoo):
    ins = _inputs(5, seed=2)
    want = np.asarray(jax.jit(zoo["jm"].apply)({"params": zoo["params"]},
                                               *map(jnp.asarray, ins)))
    model = load_flax_params(build_model(load_config(overrides=zoo["over"])),
                             zoo["tree"]).eval()
    with torch.no_grad():
        got = model(*map(torch.from_numpy, ins)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_converter_round_trip(zoo):
    model = load_flax_params(build_model(load_config(overrides=zoo["over"])),
                             zoo["tree"])
    back = params_to_flax(model)
    assert jax.tree.structure(back) == jax.tree.structure(zoo["tree"])
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.shape == b.shape and a.dtype == b.dtype
        and np.array_equal(a, b), back, zoo["tree"]))
    # Seeded weights go the other way and back unchanged too.
    seeded = init_params(build_model(load_config(overrides=zoo["over"])),
                         torch.Generator().manual_seed(3))
    again = load_flax_params(build_model(load_config(overrides=zoo["over"])),
                             params_to_flax(seeded))
    for (k, a), (_, b) in zip(seeded.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k


def _leaf_max(tree):
    """Each element's leaf's largest magnitude, in ``_vec``'s order."""
    flat = _flat(tree)
    return np.concatenate([np.full(np.size(flat[k]),
                                   np.abs(np.asarray(flat[k])).max(initial=0),
                                   np.float64) for k in sorted(flat)])


def test_adam_step(zoo):
    jcfg, tcfg = zoo["jcfg"], load_config(overrides=zoo["over"])
    jscene = jax_synthetic_scene(jcfg)
    tscene = synthetic_scene(tcfg, device="cpu")
    labeled = np.flatnonzero(jscene.label.reshape(-1)).astype(np.int32)
    ids = np.random.default_rng(4).choice(labeled, 32, replace=False)
    chunks, mask, _ = batched_ids_np(ids.astype(np.int32), 32)
    labels = jscene.label.reshape(-1)[chunks].astype(np.int32)
    batch = (chunks, labels, mask.astype(np.float32))

    jprog = JaxDualPrograms(zoo["jm"], jax_make_optimizer(jcfg, 1), jcfg,
                            jscene.width, jscene.patch)
    p, o = zoo["params"], jprog.tx.init(zoo["params"])
    o0 = _tree(o)
    assert not _vec(o0["0"]["mu"]).any() and not _vec(o0["0"]["nu"]).any()
    p, o, jl = jprog.train_epoch(p, o, (jscene.ms, jscene.pan),
                                 *map(jnp.asarray, batch))
    o1 = _tree(o)
    # optax's first mu is (1 - BETA1) * g: JAX's gradient.
    jg = _vec(o1["0"]["mu"]) / (1 - BETA1)

    model = load_flax_params(build_model(tcfg), zoo["tree"])
    opt = make_optimizer(tcfg, model.parameters(), 1)
    opt_state_from_optax(o0, model, opt)
    prog = DualPrograms(model, opt, tcfg, tscene.width, tscene.patch)
    # The forward in call order: each module that holds parameters, and
    # each activation with the smallest |input| it saw.
    calls = []

    def watch(name, act):
        def wrapped(x):
            calls.append((name, float(x.detach().abs().min())))
            return act(x)
        return wrapped

    for name, m in model.named_modules():
        if any(True for _ in m.parameters(recurse=False)):
            m.register_forward_pre_hook(
                lambda _m, _a, name=name: calls.append((name, None)))
        # Only a ReLU's gradient jumps at 0; tanh-form Gelu has no kink.
        if getattr(m, "act", None) is F.relu:
            m.act = watch(name, m.act)
    losses = prog.train_epoch((tscene.ms, tscene.pan),
                              *map(torch.from_numpy, batch))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    kinks = [i for i, (_, low) in enumerate(calls)
             if low is not None and low < KINK]
    assert [calls[i][0] for i in kinks] == KINKS.get(zoo["name"], [])
    # The parameters whose gradient flows back through a kinked unit: its
    # branch's (the first name component), up to the unit.
    upstream = {name for i in kinks for name, low in calls[:i]
                if low is None
                and name.split(".")[0] == calls[i][0].split(".")[0]}
    in_kink = _vec(params_to_flax(model, {
        n: torch.full_like(q, float(n.rsplit(".", 1)[0] in upstream))
        for n, q in model.named_parameters()})) > 0

    g = _vec(params_to_flax(model, {n: q.grad
                                    for n, q in model.named_parameters()}))
    gap = np.abs(g - jg)
    tol = GRAD_ATOL + GRAD_RTOL * _leaf_max(o1["0"]["mu"]) / (1 - BETA1)
    assert (gap <= tol)[~in_kink].all(), f"{(gap / tol)[~in_kink].max()}"
    # The kink is what parts the gradients it excuses.
    assert (gap > tol)[in_kink].any() == bool(kinks)
    got_o = opt_state_to_optax(model, opt)
    for key, decay, own in (("mu", BETA1, g), ("nu", BETA2, g * g)):
        got, want = _vec(got_o["0"][key]), _vec(o1["0"][key])
        # Everywhere: the port's moment from its own gradient.
        np.testing.assert_allclose(got, (1 - decay) * own, rtol=1e-6,
                                   atol=0, err_msg=key)
        assert (np.abs(got - want) <= 1e-5)[~in_kink].all(), key
    excused = gap > GRAD_REL * np.abs(jg)
    assert excused.mean() < 0.1, f"{excused.mean():.3f} excused"
    diff = np.abs(_vec(params_to_flax(model)) - _vec(_tree(p)))
    assert diff[~excused].max() <= 1e-5
    assert diff[excused].max(initial=0) <= 2 * LR


def test_dmfusion_dmx_served(zoo, tmp_path):
    """A dmfusion ``.dmx`` of the model, loaded by the port with its widths
    read from the param tree (the manifest has no ``trans``), serves
    dmfusion's predictions; the port's own artifact round-trips too."""
    path = tmp_path / "m.dmx"
    jax_save_artifact(path, zoo["jcfg"], zoo["params"], platforms=("cpu",))
    jscene = jax_synthetic_scene(zoo["jcfg"])
    ids = (np.arange(0, 200, dtype=np.int32) * 7) % jscene.num_pixels
    want = JaxScenePredictor(jax_load_artifact(path), jscene,
                             bucket=64).predict_ids(ids)
    act = MODELS[zoo["name"]].get("schedule", {}).get("activate", "Relu")
    clf = load_artifact(path, "cpu",
                        overrides={"schedule": {"activate": act}})
    for key, value in MODELS[zoo["name"]].items():
        got = clf.cfg[key]
        if isinstance(value, dict):  # trans: the keys the tree gives
            got = {k: got[k] for k in value}
        assert got == value, key
    scene = synthetic_scene(load_config(overrides=zoo["over"]), device="cpu")
    got = ScenePredictor(clf, scene, bucket=64).predict_ids(ids)
    assert got.dtype == np.int32 and np.array_equal(got, want)

    own = tmp_path / "own.zip"
    save_artifact(own, clf.cfg, clf.model)
    again = load_artifact(own, "cpu")
    ms, pan = map(torch.from_numpy, _inputs(4, seed=9))
    assert torch.equal(again.logits(ms, pan), clf.logits(ms, pan))


def test_layernorm_eps_is_flax():
    """flax's LayerNorm epsilon is 1e-6, torch's default 1e-5: on features
    of variance 1e-6 the two normalise differently, and the port's matches
    flax."""
    rng = np.random.default_rng(5)
    x = (1e-3 * rng.standard_normal((4, 12))).astype(np.float32)
    ln = fnn.LayerNorm()
    variables = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ln.apply(variables, jnp.asarray(x)))
    port = LayerNorm(12)
    assert port.eps == 1e-6
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        default = torch.nn.LayerNorm(12)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(default - want).max() > 0.1


def test_attention_scales_the_query_by_head_dim():
    """flax's ``MultiHeadDotProductAttention`` divides the query by
    sqrt(head_dim) (not sqrt(dim)) before the QK product; at head_dim 3,
    with sharp softmaxes from inputs of scale 4, the port's attention from
    converted ``DenseGeneral`` params matches it, and the converter's
    head layouts round-trip."""
    dim, heads = 12, 4
    rng = np.random.default_rng(6)
    q_in = (4 * rng.standard_normal((2, 5, dim))).astype(np.float32)
    kv_in = (4 * rng.standard_normal((2, 7, dim))).astype(np.float32)
    mha = fnn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=dim)
    variables = mha.init(jax.random.PRNGKey(0), jnp.asarray(q_in),
                         jnp.asarray(kv_in))
    want = np.asarray(mha.apply(variables, jnp.asarray(q_in),
                                jnp.asarray(kv_in)))
    tree = _tree(variables["params"])
    assert tree["query"]["kernel"].shape == (dim, heads, dim // heads)
    assert tree["out"]["kernel"].shape == (heads, dim // heads, dim)
    from dmfusion_torch.models.convert import HEADS_IN, HEADS_OUT, _leaf_to_torch
    port = MultiHeadAttention(dim, heads)
    state = {}
    for name, leaves in tree.items():
        kind = HEADS_OUT if name == "out" else HEADS_IN
        for leaf, arr in leaves.items():
            pname, t = _leaf_to_torch(leaf, arr, name, kind)
            state[f"{name}.{pname}"] = t
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(q_in), torch.from_numpy(kv_in)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Scaled by sqrt(dim) instead, the outputs would part far beyond that.
    port.query.weight.data *= (dim // heads / dim) ** 0.5
    port.query.bias.data *= (dim // heads / dim) ** 0.5
    with torch.no_grad():
        wrong = port(torch.from_numpy(q_in), torch.from_numpy(kv_in)).numpy()
    assert np.abs(wrong - want).max() > 1e-2
