"""dense_fusion: flax weights converted into the port give dmfusion's
features, logits and class maps, whole or in row bands, in-process and
served from a ``.dmx``.

Inputs are numpy-seeded.  f32 on both sides: features and logits within
1e-4 (abs and rel; XLA and oneDNN sum convolutions in different orders,
measured under 1e-6 here), class maps equal wherever dmfusion's top-2
logit gap is at least 1e-3 (a nearer tie may flip).  The head's second
kernel is scaled by 50 so that logits have a scale near 1 instead of the
0.02 of a fresh init.  bf16 compute: both packages round independently;
see ``BF16_ATOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.export import load_artifact as jax_load_artifact
from dmfusion.export import save_artifact as jax_save_artifact
from dmfusion.infer import ScenePredictor as JaxScenePredictor
from dmfusion.models import build_model as jax_build_model
from dmfusion.models import dense_fusion as jdense
from dmfusion.train.optim import make_optimizer
from dmfusion.train.steps import DensePrograms as JaxDensePrograms
from dmfusion.train.steps import resolve_dense_streams as jax_streams
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.export import load_artifact, read_manifest, save_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.infer import main as infer_main
from dmfusion_torch.models import build_model
from dmfusion_torch.models import dense_fusion as tdense
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import (load_flax_params, params_from_flax,
                                           params_to_flax)
from dmfusion_torch.train.steps import DensePrograms, resolve_dense_streams

TOL = dict(atol=1e-4, rtol=1e-4)
GAP = 1e-3
# bf16 compute, f32 params, width 16: the port's bf16 logits against
# dmfusion's bf16 logits of the same weights on the CPU.  Measured
# 0.015-0.024 max abs at logit scales of 0.7-2.8 (patches 8 and 16, three
# seeds each); each package alone lands 0.014-0.024 from its f32 logits.
BF16_ATOL = 0.06
H, W = 37, 42


def _over(ps, width=16, dtype="float32", **kw):
    return {"data_city": "synth64", "model_name": "dense_fusion",
            "patch_size": ps, "model_width": width, "seed": 0,
            "precision": {"compute_dtype": dtype}, **kw}


def _scene(ps, seed=None):
    rng = np.random.default_rng(ps if seed is None else seed)
    return (rng.random((H + ps - 1, W + ps - 1, 4), dtype=np.float32),
            rng.random((4 * H + 4 * ps - 1, 4 * W + 4 * ps - 1),
                       dtype=np.float32))


def _flax_tree(over, ms, pan, seed=1):
    """Seeded flax params as a numpy tree, head2 scaled to logits ~1."""
    jm = jax_build_model(jax_load_config(overrides=over))
    params = jm.init(jax.random.PRNGKey(seed), ms, pan[..., None],
                     over["patch_size"])["params"]
    tree = jax.tree.map(np.array, serialization.to_state_dict(params))
    tree["head2_kernel"] = tree["head2_kernel"] * 50.0
    return jm, tree


def _torch(over, tree):
    return load_flax_params(build_model(load_config(overrides=over)),
                            tree).eval()


def _clear(logits):
    top = np.sort(logits, axis=-1)
    return (top[..., -1] - top[..., -2]) >= GAP


def test_wsconv_matches_flax():
    """Population variance, rsqrt(var * fan_in + 1e-8) in f32, the gain
    and act_gain, symmetric SAME pad, the bias added after the conv."""
    x = np.random.default_rng(0).standard_normal((1, 9, 11, 6)
                                                 ).astype(np.float32)
    for kernel, act_gain in ((3, 2 ** 0.5), (1, 1.0)):
        jconv = jdense.WSConv(5, kernel, act_gain, jnp.float32)
        p = jax.tree.map(np.array, jconv.init(jax.random.PRNGKey(kernel),
                                              x)["params"])
        p["gain"] = p["gain"] + np.linspace(0, 1, 5, dtype=np.float32)
        p["bias"] = p["bias"] + 0.1
        want = np.asarray(jconv.apply({"params": p}, x))
        tconv = tdense.WSConv(6, 5, kernel, act_gain, torch.float32)
        with torch.no_grad():
            tconv.weight.copy_(
                torch.from_numpy(p["kernel"]).permute(3, 2, 0, 1))
            tconv.gain.copy_(torch.from_numpy(p["gain"]))
            tconv.bias.copy_(torch.from_numpy(p["bias"]))
            got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("in_f,features", [(6, 8), (8, 8)])
def test_local_res_block_matches_flax(in_f, features):
    """act(sc + alpha * y), with the 1x1 WSConv shortcut only where the
    width changes."""
    x = np.random.default_rng(in_f).standard_normal((1, 9, 11, in_f)
                                                    ).astype(np.float32)
    jblock = jdense.LocalResBlock(features, dtype=jnp.float32)
    p = jax.tree.map(np.array, jblock.init(jax.random.PRNGKey(0), x)["params"])
    p["alpha"] = np.float32(0.7)
    want = np.asarray(jblock.apply({"params": p}, x))
    tblock = tdense.LocalResBlock(in_f, features, dtype=torch.float32)
    assert (tblock.shortcut is None) == (in_f == features)
    tblock.load_state_dict(params_from_flax(p, root="LocalResBlock"),
                           strict=True)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("ps", [8, 16, 7])
def test_dense_net_matches_f32(ps):
    """features_s2d, the logits map and the class map at f32; patch 7
    takes the odd route (full-res window mean, head per pixel)."""
    over = _over(ps)
    ms, pan = _scene(ps)
    jm, tree = _flax_tree(over, ms, pan)
    v = {"params": tree}
    pan3 = pan[..., None]
    want_f = np.asarray(jm.apply(v, ms, pan3, method=jm.features_s2d))
    want = np.asarray(jm.apply(v, ms, pan3, ps))
    want_cm = np.asarray(jm.apply(v, ms, pan3, ps, method=jm.class_map))
    tm = _torch(over, tree)
    with torch.no_grad():
        tms, tpan = torch.from_numpy(ms), torch.from_numpy(pan)
        got_f = tm.features_s2d(tms, tpan).numpy()
        got = tm(tms, tpan, ps).numpy()
        got_cm = tm.class_map(tms, tpan, ps).numpy()
    assert got_f.shape == want_f.shape == (-(-(H + ps - 1) // 2),
                                           -(-(W + ps - 1) // 2), 64)
    np.testing.assert_allclose(got_f, want_f, **TOL)
    assert got.dtype == np.float32 and got.shape == want.shape == (H, W, 5)
    assert np.abs(want).max() > 0.3
    np.testing.assert_allclose(got, want, **TOL)
    assert got_cm.dtype == np.int32 and got_cm.shape == (H, W)
    clear = _clear(want)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_cm[clear], want_cm[clear])
    np.testing.assert_array_equal(got_cm, got.argmax(-1))


@pytest.mark.parametrize("ps", [8, 16])
def test_dense_net_bf16_logits(ps):
    over = _over(ps, dtype="bfloat16")
    ms, pan = _scene(ps, seed=ps + 1)
    jm, tree = _flax_tree(over, ms, pan)
    want = np.asarray(jm.apply({"params": tree}, ms, pan[..., None], ps))
    with torch.no_grad():
        got = _torch(over, tree)(torch.from_numpy(ms), torch.from_numpy(pan),
                                 ps)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_dense_converter_round_trip_and_init():
    over = _over(8)
    ms, pan = _scene(8)
    _, tree = _flax_tree(over, ms, pan)
    tm = _torch(over, tree)
    back = params_to_flax(tm)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, back))
    with pytest.raises(ValueError, match="left unused"):
        load_flax_params(build_model(load_config(overrides=over)),
                         {**tree, "head3_kernel": np.zeros((2, 2))})
    missing = {k: v for k, v in tree.items() if k != "trunk2"}
    with pytest.raises(ValueError, match="left unset"):
        load_flax_params(build_model(load_config(overrides=over)), missing)
    # Seeded init: the flax initializers' constants and scales.
    m = init_params(build_model(load_config(overrides=over)),
                    torch.Generator().manual_seed(0))
    assert float(m.trunk1.alpha.detach()) == pytest.approx(0.2)
    assert torch.equal(m.refine.conv.gain, torch.ones(64))
    assert not m.ms_block.conv.bias.any() and not m.head2_bias.any()
    fan_in = m.refine.conv.weight[0].numel()
    assert float(m.refine.conv.weight.std()) == pytest.approx(
        (2 / fan_in) ** 0.5, rel=0.05)
    assert float(m.head1_kernel.std()) == pytest.approx(16 ** -0.5, rel=0.2)


TALL = {"DATA_DICT": {"synthtall": {
    "size": [96, 40, 4],
    "color": [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]]}},
    "data_city": "synthtall"}


def test_band_plan_and_knobs_match_jax():
    cfg = jax_load_config(overrides={**_over(8), **TALL})
    jprog = JaxDensePrograms(jax_build_model(cfg), make_optimizer(cfg, 1),
                             cfg, 40, 8, None)
    prog = DensePrograms(None, 8)
    for rows in (103, 104, 71, 2016):
        for parts in (1, 2, 3, 5):
            plan = prog.band_plan(rows, parts)
            assert plan == jprog._band_plan(rows, parts)
            if plan is None:
                continue
            for i in range(parts):
                want = tuple(int(v) for v in jprog._band_slices(plan, i, rows))
                assert prog.band_slices(plan, i, rows) == want
    for value in ("auto", "off", 0, 1, "4", 16, "on"):
        for rows, cols in ((2001, 2101), (6905, 7300), (64, 72)):
            assert resolve_dense_streams(value, rows, cols) == jax_streams(
                value, rows, cols)


@pytest.mark.parametrize("n_bands", [2, 3])
def test_streamed_class_map(n_bands):
    """Row bands give the whole map and dmfusion's class_map_streamed."""
    over = {**_over(8, width=8), **TALL}
    jcfg = jax_load_config(overrides=over)
    jscene = jax_synthetic_scene(jcfg)
    ms, pan = np.array(jscene.ms), np.array(jscene.pan)
    jm, tree = _flax_tree(over, ms, pan)
    jprog = JaxDensePrograms(jm, make_optimizer(jcfg, 1), jcfg, 40, 8, None)
    want = np.asarray(jprog.class_map_streamed(tree, (jscene.ms, jscene.pan),
                                               n_bands))
    logits = np.asarray(jm.apply({"params": tree}, ms, pan[..., None], 8))
    prog = DensePrograms(_torch(over, tree), 8)
    assert prog.band_plan(ms.shape[0], n_bands) is not None
    tms, tpan = torch.from_numpy(ms), torch.from_numpy(pan)
    got = prog.class_map_streamed(tms, tpan, n_bands).numpy()
    whole = prog.predict_map(tms, tpan, 0).numpy()
    assert got.shape == whole.shape == want.shape == (96, 40)
    clear = _clear(logits)
    np.testing.assert_array_equal(got[clear], whole[clear])
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got == whole).mean() >= 0.999


# A dense .dmx trained with Gelu: dmfusion's export records no activation.
GELU = {"schedule": {"activate": "Gelu"}}


@pytest.fixture(scope="module")
def dense_dmx(tmp_path_factory):
    over = {**_over(8), **GELU}
    cfg = jax_load_config(overrides=over)
    ms, pan = _scene(8)
    _, tree = _flax_tree(over, ms, pan)
    path = tmp_path_factory.mktemp("dense") / "dense.dmx"
    jax_save_artifact(path, cfg, jax.tree.map(jnp.asarray, tree),
                      platforms=("cpu",))
    return path, cfg, tree


def test_dense_dmx_served_like_dmfusion(dense_dmx):
    path, cfg, tree = dense_dmx
    jclf = jax_load_artifact(path)
    jscene = jax_synthetic_scene(cfg)
    jpred = JaxScenePredictor(jclf, jscene)
    want = jpred.class_map()
    want_m = jpred.evaluate()
    jm = jax_build_model(cfg)
    logits = np.asarray(jm.apply({"params": tree}, jscene.ms,
                                 jscene.pan[..., None], 8))

    clf = load_artifact(path, "cpu", overrides=GELU)
    assert clf.is_map and clf.manifest["dense_bands"] == 0
    scene = synthetic_scene(load_config(overrides=_over(8)), device="cpu")
    pred = ScenePredictor(clf, scene)
    got = pred.class_map()
    assert got.shape == want.shape == (scene.height, scene.width)
    clear = _clear(logits)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    m = pred.evaluate()
    labeled = np.flatnonzero(scene.label.reshape(-1)).astype(np.int32)
    x, y = scene.ids_to_xy(labeled)
    assert m["pixels"] == want_m["pixels"] == labeled.size
    assert abs(m["oa"] - want_m["oa"]) <= (got[x, y] != want[x, y]).mean()
    np.testing.assert_array_equal(pred.predict_ids(labeled), got[x, y])
    with pytest.raises(ValueError, match="class_map"):
        clf.predict(scene.ms, scene.pan)


def test_dense_dmx_without_activation_raises(dense_dmx):
    with pytest.raises(ValueError, match="schedule.activate"):
        load_artifact(dense_dmx[0], "cpu")


def test_dense_own_artifact_and_cli(tmp_path, capsys):
    """The port's own dense artifact: manifest keys of a dense .dmx, the
    same class map after a round trip, and the CLI serving it."""
    over = _over(8, width=8)
    cfg = load_config(overrides=over)
    model = init_params(build_model(cfg), torch.Generator().manual_seed(2))
    path = tmp_path / "dense.zip"
    manifest = save_artifact(path, cfg, model)
    assert manifest["arity"] == "dense" and manifest["batch"] == "scene"
    assert manifest["scene_shape"] == [64, 72, 4]
    assert manifest["dense_bands"] == 0 and "gmfnet_pan" not in manifest
    assert manifest["input_shapes"] == [["71", "79", "4"], ["287", "319"]]
    assert read_manifest(path) == manifest
    scene = synthetic_scene(cfg, device="cpu")
    with torch.no_grad():
        want = model.eval().class_map(scene.ms, scene.pan, 8).numpy()
    pred = ScenePredictor(load_artifact(path, "cpu"), scene)
    np.testing.assert_array_equal(pred.class_map(), want)
    other = synthetic_scene(load_config(overrides={**over, **TALL}),
                            device="cpu")
    with pytest.raises(ValueError, match="scene geometry"):
        ScenePredictor(load_artifact(path, "cpu"), other)

    infer_main(["--artifact", str(path), "--set", "device=cpu",
                "--out", str(tmp_path)])
    import json
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["model"] == "dense_fusion" and result["activate"] == "Relu"
    assert 0.0 <= result["oa"] <= 1.0 and len(result["maps"]) == 2
