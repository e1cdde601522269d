"""gmfnet_conv and ConvMapPrograms: the port's shift-and-stitch map route
against its own window route, and both against dmfusion's, on the CPU in
float32 at the JAX package's test sizes (width 8; patch 35, 39 and 43).

* The port's own exactness, at the JAX tests' tolerances (rtol 1e-5,
  atol 2e-5): the window route against ``logits_map`` at every one of the
  16 (x % 4, y % 4) phases, at g = 2 and g = 4; ``class_map`` equal to the
  window route's argmax; banded maps equal to the whole map; the map-route
  test confusion equal to the per-anchor one.
* Against dmfusion, from flax params converted by ``convert.py`` (the
  second head kernel scaled by 20 so logits have a scale near 1): window
  logits and ``logits_map`` within 1e-4 (XLA and oneDNN sum convolutions
  in different orders; measured under 1e-6 here); class maps equal
  wherever dmfusion's top-two gap exceeds ``GAP``, the rest counted and
  at most 0.1 %; banded ``predict_map`` equal; ``resolve_conv_streams``
  equal; three Adam steps of the window route with losses within 1e-4.
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
from dmfusion.models import gmfnet_conv as jconv
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import ConvMapPrograms as JaxConvMapPrograms
from dmfusion.train.steps import resolve_conv_streams as jax_conv_streams
from dmfusion_torch.config import load_config
from dmfusion_torch.models import build_model
from dmfusion_torch.models import gmfnet_conv as tconv
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import load_flax_params, params_to_flax
from dmfusion_torch.models.registry import model_map_programs
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import (ConvMapPrograms, DualPrograms,
                                        resolve_conv_streams)

EXACT = dict(rtol=1e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
GAP = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(patch, width=8, **kw):
    return {"data_city": "synth64", "model_name": "gmfnet_conv",
            "patch_size": patch, "model_width": width, "seed": 0,
            "precision": {"compute_dtype": "float32",
                          "param_dtype": "float32"}, **kw}


def _scene(h, w, patch, seed=0):
    rng = np.random.default_rng(seed)
    ms = rng.standard_normal((h + patch - 1, w + patch - 1, 4)
                             ).astype(np.float32)
    pan = rng.standard_normal((4 * (h + patch - 1), 4 * (w + patch - 1))
                              ).astype(np.float32)
    return ms, pan


def _flax(over, seed=0, head_scale=20.0):
    """dmfusion's model and seeded params (numpy tree), head2 scaled."""
    patch = over["patch_size"]
    jm = jax_build_model(jax_load_config(overrides=over))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, patch, patch, 4)),
                              jnp.zeros((1, 4 * patch, 4 * patch, 1))
                              )["params"]
    tree = jax.tree.map(np.array, serialization.to_state_dict(params))
    tree["head2"]["kernel"] = tree["head2"]["kernel"] * head_scale
    return jm, tree


def _torch(over, tree):
    return load_flax_params(build_model(load_config(overrides=over)),
                            tree).eval()


def _windows(ms, pan, patch, h, w):
    """Every anchor's (MS, PAN) window, row-major, NHWC."""
    xs, ys = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ms_w = np.stack([ms[x:x + patch, y:y + patch]
                     for x, y in zip(xs.ravel(), ys.ravel())])
    pan_w = np.stack([pan[4 * x:4 * x + 4 * patch, 4 * y:4 * y + 4 * patch,
                          None] for x, y in zip(xs.ravel(), ys.ravel())])
    return ms_w, pan_w


@pytest.fixture(scope="module", params=[(39, 13, 11, 0), (43, 6, 9, 3)],
                ids=["g2_all_phases", "g4"])
def routes(request):
    """Both packages' window logits, logits map and class map at one
    geometry (13 x 11 anchors cover all 16 phases; patch 43 has g = 4)."""
    patch, h, w, seed = request.param
    over = _over(patch)
    ms, pan = _scene(h, w, patch, seed)
    jm, tree = _flax(over, seed)
    v = {"params": tree}
    ms_w, pan_w = _windows(ms, pan, patch, h, w)
    # Jitted: one compile each, several times faster than op by op.
    lmap = jax.jit(lambda v, a, b: jm.apply(v, a, b, patch,
                                            method=jm.logits_map))
    jax_out = {
        "window": np.asarray(jax.jit(jm.apply)(v, ms_w, pan_w)
                             ).reshape(h, w, -1),
        "map": np.asarray(lmap(v, ms, pan))}
    # dmfusion's class_map is its logits map's argmax
    # (tests/test_gmfnet_conv.py): one compile fewer.
    jax_out["class"] = jax_out["map"].argmax(-1)
    tm = _torch(over, tree)
    with torch.no_grad():
        tms, tpan = torch.from_numpy(ms), torch.from_numpy(pan)
        port = {"window": tm(torch.from_numpy(ms_w), torch.from_numpy(pan_w)
                             ).numpy().reshape(h, w, -1),
                "map": tm.logits_map(tms, tpan, patch).numpy(),
                "class": tm.class_map(tms, tpan, patch).numpy()}
    return {"jax": jax_out, "port": port, "shape": (h, w)}


def test_pool_grid_matches_jax():
    for patch in (35, 39, 43, 47, 51):
        assert tconv.pool_grid(patch) == jconv.pool_grid(patch)
    for bad in (16, 36, 40, 31):
        with pytest.raises(ValueError, match="gmfnet_conv"):
            tconv.pool_grid(bad)


@pytest.mark.parametrize("stride", [1, 2])
def test_wsconv_valid_and_strided_match_flax(stride):
    """WSConv's VALID padding and call-time stride: the same parameters at
    stride 1 and 2, as the scene route needs; SAME stays stride 1."""
    from dmfusion.models.dense_fusion import WSConv as JaxWSConv
    from dmfusion_torch.models.dense_fusion import WSConv
    x = np.random.default_rng(stride).standard_normal((2, 12, 11, 6)
                                                      ).astype(np.float32)
    jconv_ = JaxWSConv(5, 3, 2 ** 0.5, jnp.float32, padding="VALID")
    p = jax.tree.map(np.array, jconv_.init(jax.random.PRNGKey(0), x)["params"])
    p["bias"] = p["bias"] + 0.1
    want = np.asarray(jconv_.apply({"params": p}, x, stride=stride))
    tconv_ = WSConv(6, 5, 3, 2 ** 0.5, torch.float32, padding="VALID")
    tconv_.load_state_dict({
        "weight": torch.from_numpy(p["kernel"]).permute(3, 2, 0, 1),
        "gain": torch.from_numpy(p["gain"]),
        "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        got = tconv_(torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride)
    assert got.shape[2:] == want.shape[1:3]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    with pytest.raises(ValueError, match="stride 1"):
        WSConv(6, 5)(torch.from_numpy(x).permute(0, 3, 1, 2), stride=2)


def test_window_route_equals_map_route(routes):
    """The port's own exactness: every anchor's map-route logits are its
    window-route logits; the class map is their argmax."""
    p = routes["port"]
    assert p["map"].shape == p["window"].shape == (*routes["shape"],
                                                   p["map"].shape[-1])
    assert p["map"].dtype == np.float32
    np.testing.assert_allclose(p["map"], p["window"], **EXACT)
    assert p["class"].dtype == np.int32
    np.testing.assert_array_equal(p["class"], p["window"].argmax(-1))


def test_routes_match_dmfusion(routes):
    j, p = routes["jax"], routes["port"]
    assert np.abs(j["map"]).max() > 0.3
    np.testing.assert_allclose(p["window"], j["window"], **TOL)
    np.testing.assert_allclose(p["map"], j["map"], **TOL)
    top = np.sort(j["map"], axis=-1)
    clear = (top[..., -1] - top[..., -2]) > GAP
    np.testing.assert_array_equal(p["class"][clear], j["class"][clear])
    assert (~clear).mean() <= 1e-3


def test_channel_order_is_phase_major():
    """The window route's PAN packing is space_to_depth's order: a
    permuted order passes every shape check and fails only here."""
    pan = torch.arange(2 * 8 * 8 * 1, dtype=torch.float32).reshape(2, 8, 8, 1)
    got = tconv._s2d4_batched(pan)
    from dmfusion_torch.models.dense_fusion import space_to_depth
    for b in range(2):
        assert torch.equal(got[b], space_to_depth(pan[b], 4))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jconv._s2d4_batched(jnp.asarray(pan.numpy()))))


def test_split2_and_box_sum_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 11, 3)
                                                 ).astype(np.float32)
    want = np.asarray(jconv._split2(jnp.asarray(x), 4, 5))
    got = tconv._split2(torch.from_numpy(x).permute(0, 3, 1, 2), 4, 5)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(jconv._box_sum(jnp.asarray(x, jnp.bfloat16), 3, 1))
    got = tconv._box_sum(xb.permute(0, 3, 1, 2), 3, 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def banded():
    """A 41 x 9 anchor scene at patch 35: dmfusion's and the port's
    programs over the same converted weights."""
    patch, h, w = 35, 41, 9
    over = _over(patch, conv_streams="auto")
    ms, pan = _scene(h, w, patch, seed=5)
    jm, tree = _flax(over, seed=2)
    jcfg = jax_load_config(overrides=over)
    jprog = JaxConvMapPrograms(jm, optax.sgd(1e-3), jcfg, w, patch)
    tcfg = load_config(overrides=over)
    tprog = ConvMapPrograms(_torch(over, tree), None, tcfg, w, patch)
    return {"jprog": jprog, "tree": tree, "tprog": tprog,
            "jargs": (jnp.asarray(ms), jnp.asarray(pan)),
            "targs": (torch.from_numpy(ms), torch.from_numpy(pan)),
            "shape": (h, w)}


def test_banded_maps_equal_whole(banded):
    prog = banded["tprog"]
    whole = prog.predict_map(*banded["targs"])
    assert whole.shape == banded["shape"] and whole.dtype == torch.int32
    for n in (2, 3, 5):
        assert prog.band_plan(banded["targs"][0].shape[0], n) is not None
        assert torch.equal(prog.class_map_streamed(*banded["targs"], n),
                           whole), n


@pytest.mark.parametrize("n", [2, 3])
def test_banded_predict_map_matches_dmfusion(banded, n):
    rows = banded["targs"][0].shape[0]
    plan = banded["tprog"].band_plan(rows, n)
    assert plan == banded["jprog"]._cm_band_plan(rows, n)
    for i in range(n):
        want = tuple(int(v) for v in banded["jprog"]._cm_band_slices(
            plan, i, rows))
        assert banded["tprog"].band_slices(plan, i, rows) == want
    jcfg = dict(banded["jprog"].cfg, conv_streams=n)
    jprog = JaxConvMapPrograms(banded["jprog"].model, optax.sgd(1e-3), jcfg,
                               banded["shape"][1], 35)
    want = np.asarray(jprog.predict_map(banded["tree"], banded["jargs"]))
    got = banded["tprog"].predict_map(*banded["targs"], n).numpy()
    np.testing.assert_array_equal(got, want)


def test_map_route_test_confusion_is_exact(banded):
    """ConvMapPrograms.test_confusion (one map) equals the per-anchor
    eval route's confusion."""
    prog = banded["tprog"]
    h, w = banded["shape"]
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.choice(h * w, size=(2, 32), replace=False)
                           .astype(np.int32))
    labels = torch.from_numpy(rng.integers(1, 4, size=(2, 32)))
    mask = torch.ones(2, 32)
    mask[1, 20:] = 0
    got = prog.test_confusion(banded["targs"], ids, labels, mask)
    want = DualPrograms.test_confusion(prog, banded["targs"], ids, labels,
                                       mask)
    assert torch.equal(got, want) and int(got.sum()) == 52


def test_resolve_conv_streams_matches_dmfusion():
    for v in ("auto", "off", "0", None, 3, "5", ""):
        for rows, cols in ((2047, 2147), (4587, 4594), (8000, 6000),
                           (100, 80)):
            for width in (8, 64, 128):
                assert resolve_conv_streams(v, rows, cols, 47, width) == \
                    jax_conv_streams(v, rows, cols, 47, width), (v, rows)
    with pytest.raises(ValueError, match="conv_streams"):
        resolve_conv_streams("many", 100, 100, 47)


def test_converter_round_trip_and_refuses_gmfnet_tree():
    over = _over(35)
    _, tree = _flax(over)
    tm = _torch(over, tree)
    back = params_to_flax(tm)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, back))
    gm = jax_build_model(jax_load_config(overrides={**over,
                                                    "model_name": "gmfnet"}))
    gparams = jax.jit(gm.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 35, 35, 4)),
                               jnp.zeros((1, 140, 140, 1)))["params"]
    gtree = jax.tree.map(np.array, serialization.to_state_dict(gparams))
    with pytest.raises(ValueError, match="left unused"):
        load_flax_params(build_model(load_config(overrides=over)), gtree)
    missing = {k: v for k, v in tree.items() if k != "alpha2"}
    with pytest.raises(ValueError, match="left unset"):
        load_flax_params(build_model(load_config(overrides=over)), missing)
    assert model_map_programs("gmfnet_conv") == "convmap"
    assert model_map_programs("gmfnet") is None
    assert model_map_programs("dense_fusion") is None
    # Seeded init: the residual scales and WSConv's he-normal kernels.
    m = init_params(build_model(load_config(overrides=over)),
                    torch.Generator().manual_seed(0))
    assert float(m.alpha3.detach()) == pytest.approx(0.2)
    assert torch.equal(m.t3_c2.gain, torch.ones(32))
    fan_in = m.t3_c2.weight[0].numel()
    assert float(m.t3_c2.weight.detach().std()) == pytest.approx(
        (2 / fan_in) ** 0.5, rel=0.05)


def test_adam_steps_match_optax():
    """Three Adam steps of the window route (the training path) from the
    same converted weights on the same windows: per-step losses within
    1e-4 of dmfusion's."""
    patch, h, w = 35, 12, 10
    over = _over(patch)
    ms, pan = _scene(h, w, patch, seed=9)
    jm, tree = _flax(over, seed=4, head_scale=1.0)
    jcfg = jax_load_config(overrides=over)
    tx = jax_make_optimizer(jcfg, 3)
    jprog = JaxConvMapPrograms(jm, tx, jcfg, w, patch)
    rng = np.random.default_rng(3)
    ids = rng.choice(h * w, size=(3, 16), replace=False).astype(np.int32)
    labels = rng.integers(1, 4, size=(3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.float32)
    mask[2, 10:] = 0
    params = jax.tree.map(jnp.asarray, tree)
    _, _, jl = jprog.train_epoch(params, tx.init(params),
                                 (jnp.asarray(ms), jnp.asarray(pan)),
                                 jnp.asarray(ids), jnp.asarray(labels),
                                 jnp.asarray(mask))
    tcfg = load_config(overrides=over)
    model = _torch(over, tree)
    tprog = ConvMapPrograms(model, make_optimizer(tcfg, model.parameters(),
                                                  3), tcfg, w, patch)
    tl = tprog.train_epoch((torch.from_numpy(ms), torch.from_numpy(pan)),
                           *map(torch.from_numpy, (ids, labels, mask)))
    assert np.all(np.isfinite(np.asarray(jl)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert tprog.optimizer.param_groups[0]["count"] == 3
