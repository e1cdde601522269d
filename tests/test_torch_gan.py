"""Stage 1 of the two-stage solver in the port against dmfusion's, on the
CPU in float32 (gan_width 8, pic 32, batch 2, the config's lr 1e-4): the
generator and discriminator, the converter of one optimizer over two
models, ``GanPrograms``' steps and epochs, and the numpy image ops and
sample grids.

Tolerances:
  * the generator and discriminator forward, on flax-initialized params
    converted in: atol 1e-5 (readings 1.9e-6 and 4.8e-7);
  * the optax states of ``opt_g`` and ``opt_d`` (one Adam over two nets
    each): equal, both directions;
  * each of three ``GanPrograms`` steps from JAX's own params, optax
    states and noise: the fakes atol 1e-5 (readings up to 8.9e-7); the d
    and g losses within 1e-5 + 1e-6 of their size (readings 7.2e-7 and
    6.7e-6, at losses of 1.8-2.3 and 10.9-11.1); the update counts equal;
    Adam's moments atol 1e-5 (5.4e-7); the updated parameters atol 1e-5
    (1.2e-7) except where the gradient is tiny (a conv bias before a
    GroupNorm of one channel a group) or the packages' gradients part by
    more than ``GRAD_REL`` of JAX's (at most 1 % of the elements; readings
    0.02-0.21 %), held there to Adam's step bound, ``2 * lr`` (largest
    reading 1.4e-4).  Each step starts from JAX's state because Adam's
    steps move an element by about ``lr`` whatever its gradient's size,
    so chained steps would part where the gradient is rounding noise;
  * an epoch: every ``collect`` mode gives dmfusion's output shapes, the
    same losses, and an 'all' epoch equals the steps it stacks, bit for
    bit;
  * ``ops/image.py`` and ``save_image_grid``'s decoded pixels: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from dmfusion.config import load_config as jax_load_config
from dmfusion.models import build_model as jax_build_model
from dmfusion.ops import image as jax_image
from dmfusion.report.viz import save_image_grid as jax_save_image_grid
from dmfusion.train.gan import GanPrograms as JaxGanPrograms
from dmfusion_torch.config import load_config
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           opt_state_to_optax, params_to_flax)
from dmfusion_torch.ops import image
from dmfusion_torch.report.viz import save_image_grid
from dmfusion_torch.train.gan import GanPrograms

OVER = {"data_city": "synth64", "gan_width": 8,
        "dqtl": {"pic_size": 32, "batch_size": 2},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
NETS = {"gP": "generator", "gM": "generator", "dP": "discriminator",
        "dM": "discriminator"}
OPTS = {"opt_g": ("gP", "gM"), "opt_d": ("dP", "dM")}
LR, STEPS, TINY_GRAD, GRAD_REL = 1e-4, 3, 1e-7, 1e-3
BETA1 = 0.5  # adam_beta's first decay


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
    flat = _flat(tree)
    return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                           for k in sorted(flat)])


@pytest.fixture(scope="module")
def jax_steps():
    """Three dmfusion GAN steps, one jitted call each: the state before
    and after, the noise each drew and its outputs."""
    cfg = jax_load_config(overrides=OVER)
    prog = JaxGanPrograms(*(jax_build_model(cfg, n) for n in NETS.values()),
                          cfg)
    state = prog.init(jax.random.PRNGKey(0), 32, 4)
    rng = np.random.default_rng(0)
    m = rng.random((STEPS, 2, 32, 32, 4), dtype=np.float32)
    p = rng.random((STEPS, 2, 32, 32, 4), dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), STEPS)
    step = jax.jit(prog._step)
    out = []
    for i in range(STEPS):
        km, kp = jax.random.split(keys[i])
        noise = (np.array(jax.random.normal(km, m[i].shape)),
                 np.array(jax.random.normal(kp, p[i].shape)))
        before = _tree(state)
        state, res = step(state, jnp.asarray(m[i]), jnp.asarray(p[i]),
                          keys[i])
        out.append({"before": before, "after": _tree(state),
                    "noise": noise, "out": jax.tree.map(np.asarray, res)})
    return {"prog": prog, "m": m, "p": p, "steps": out}


def _port(state):
    """The port's ``GanPrograms`` holding dmfusion's ``state``."""
    cfg = load_config(overrides=OVER)
    nets = {k: load_flax_params(build_model(cfg, n), state["params"][k])
            for k, n in NETS.items()}
    prog = GanPrograms(*nets.values(), cfg)
    for opt, keys in OPTS.items():
        opt_state_from_optax(state[opt], {k: nets[k] for k in keys},
                             getattr(prog, opt))
    return prog


@pytest.mark.parametrize("name", ["generator", "discriminator"])
def test_forward_matches_flax_and_round_trips(name):
    jm = jax_build_model(jax_load_config(overrides=OVER), name)
    x = np.random.default_rng(0).random((3, 32, 32, 4), dtype=np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tree = _tree(params)
    model = load_flax_params(build_model(load_config(overrides=OVER), name),
                             tree)
    assert type(model).widths_from_tree(tree) == {"gan_width": 8}
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    shape = (3, 32, 32, 4) if name == "generator" else (3, 4, 4, 1)
    assert got.dtype == np.float32 and got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = params_to_flax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(tree), strict=True))


def test_discriminator_first_block_has_no_norm():
    model = build_model(load_config(overrides=OVER), "discriminator")
    assert model.blocks[0].norm is None
    assert all(b.norm is not None for b in model.blocks[1:])
    gen = build_model(load_config(overrides=OVER), "generator")
    assert all(b.norm is not None for b in (gen.enc1, gen.enc2, gen.dec))


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_two_model_opt_state_round_trip(jax_steps, opt):
    """``opt_g`` (one Adam over gP and gM) and ``opt_d`` (over dP and dM)
    after a step: optax -> port -> optax is exact, and a tree of other
    keys is refused."""
    state = jax_steps["steps"][0]["after"]
    prog = _port(state)
    nets = {k: prog.nets[k] for k in OPTS[opt]}
    back = opt_state_to_optax(nets, getattr(prog, opt))
    want = state[opt]
    assert back["1"] == {} and int(back["0"]["count"]) == 1
    for key in ("mu", "nu"):
        assert jax.tree.structure(back["0"][key]) == jax.tree.structure(
            want["0"][key])
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(back["0"][key]), jax.tree.leaves(want["0"][key]),
            strict=True))
    one = {OPTS[opt][0]: nets[OPTS[opt][0]]}
    with pytest.raises(ValueError, match="tree holds"):
        opt_state_from_optax(want, one, getattr(prog, opt))


@pytest.mark.parametrize("step", range(STEPS))
def test_step_from_jax_state(jax_steps, step):
    """One D + G step from dmfusion's params, optax states and noise."""
    st = jax_steps["steps"][step]
    prog = _port(st["before"])
    r = prog.step(*(torch.from_numpy(a[step]) for a in (jax_steps["m"],
                                                         jax_steps["p"])),
                  *map(torch.from_numpy, st["noise"]))
    want = st["out"]
    for k in ("fake_pan", "fake_ms"):
        np.testing.assert_allclose(r[k].numpy(), want[k], rtol=0, atol=1e-5)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(r[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-5)
    after = st["after"]
    for opt, keys in OPTS.items():
        nets = {k: prog.nets[k] for k in keys}
        got = opt_state_to_optax(nets, getattr(prog, opt))
        assert int(got["0"]["count"]) == int(after[opt]["0"]["count"]) \
            == step + 1
        for key in ("mu", "nu"):
            np.testing.assert_allclose(_vec(got["0"][key]),
                                       _vec(after[opt]["0"][key]), rtol=0,
                                       atol=1e-5, err_msg=f"{opt} {key}")
        # optax's mu is BETA1 * mu0 + (1 - BETA1) * g: JAX's gradient.
        jg = (_vec(after[opt]["0"]["mu"])
              - BETA1 * _vec(st["before"][opt]["0"]["mu"])) / (1 - BETA1)
        g = _vec({k: params_to_flax(n, {pn: q.grad for pn, q in
                                        n.named_parameters()})
                  for k, n in nets.items()})
        excused = (np.abs(g) < TINY_GRAD) | (np.abs(g - jg)
                                             > GRAD_REL * np.abs(jg))
        assert excused.mean() < 0.01, f"{opt}: {excused.mean():.4f} excused"
        diff = np.abs(_vec({k: params_to_flax(n) for k, n in nets.items()})
                      - _vec({k: after["params"][k] for k in keys}))
        assert diff[~excused].max() <= 1e-5, opt
        assert diff[excused].max(initial=0) <= 2 * LR, opt


def test_generator_pass_leaves_discriminator_grads(jax_steps):
    """After a step the discriminators' gradients are the D step's alone:
    the generator pass added none (they equal a D-only backward)."""
    st = jax_steps["steps"][0]
    prog = _port(st["before"])
    m, p = (torch.from_numpy(a[0]) for a in (jax_steps["m"], jax_steps["p"]))
    n_m, n_p = map(torch.from_numpy, st["noise"])
    ref = _port(st["before"])
    with torch.no_grad():
        fp, fm = ref.nets["gP"](n_m), ref.nets["gM"](n_p)
    dp, dm = ref.nets["dP"], ref.nets["dM"]
    loss = sum(torch.mean((d(x) - t) ** 2) for d, x, t in (
        (dp, p, 1.0), (dp, fp, 0.0), (dm, m, 1.0), (dm, fm, 0.0)))
    loss.backward()
    prog.step(m, p, n_m, n_p)
    for k in ("dP", "dM"):
        for (name, q), (_, r) in zip(prog.nets[k].named_parameters(),
                                     ref.nets[k].named_parameters()):
            torch.testing.assert_close(q.grad, r.grad, rtol=1e-5, atol=1e-7,
                                       msg=f"{k}.{name}")


def test_collect_modes(jax_steps):
    """'all', 'first' and 'none' give dmfusion's output shapes and the same
    losses; 'all' equals the steps it stacks, bit for bit."""
    jprog = jax_steps["prog"]
    m, p = (torch.from_numpy(a) for a in (jax_steps["m"], jax_steps["p"]))
    noise = [tuple(map(torch.from_numpy, st["noise"]))
             for st in jax_steps["steps"]]
    start = jax_steps["steps"][0]["before"]
    state_shape = jax.eval_shape(lambda: jprog.init(jax.random.PRNGKey(0),
                                                    32, 4))
    tiles = jax.ShapeDtypeStruct(m.shape, jnp.float32)
    keys = jax.ShapeDtypeStruct((STEPS, 2), jnp.uint32)
    outs = {}
    for collect in ("all", "first", "none"):
        prog = _port(start)
        draws = iter(noise)
        prog.noise = lambda _m, _p: next(draws)
        outs[collect] = prog.train_epoch(m, p, collect)
        _, want = jax.eval_shape(lambda s, a, b, k, c=collect:
                                 jprog._train_epoch(s, a, b, k, c),
                                 state_shape, tiles, tiles, keys)
        assert {k: tuple(v.shape) for k, v in outs[collect].items()} == \
            {k: tuple(v.shape) for k, v in want.items()}, collect
    prog = _port(start)
    stepped = [prog.step(m[i], p[i], *noise[i]) for i in range(STEPS)]
    for k in ("fake_pan", "fake_ms"):
        assert torch.equal(outs["all"][k], torch.stack([s[k]
                                                        for s in stepped]))
        assert torch.equal(outs["first"][k], stepped[0][k])
    for k in ("d_loss", "g_loss"):
        want = torch.stack([s[k] for s in stepped])
        assert all(torch.equal(o[k], want) for o in outs.values())
    with pytest.raises(ValueError, match="collect"):
        prog.train_epoch(m, p, "last")


def test_image_ops_equal_dmfusion(tmp_path):
    """The port's copy of ``ops/image.py`` gives dmfusion's output."""
    rng = np.random.default_rng(4)
    band = rng.integers(0, 200, (37, 41)).astype(np.uint8)
    assert np.array_equal(image.equalize_histogram(band),
                          jax_image.equalize_histogram(band))
    for img in (rng.random((4, 30, 35), dtype=np.float32),
                rng.random((1, 30, 35), dtype=np.float32),
                rng.random((30, 35), dtype=np.float32)):
        for eq in (True, False):
            got = image.render_tensor(img, eq)
            assert got.dtype == np.uint8
            assert np.array_equal(got, jax_image.render_tensor(img, eq))
    label = rng.integers(0, 5, (20, 24))
    gt = rng.integers(0, 255, (20, 24, 3)) * (label[..., None] != 2)
    assert image.discover_palette(label, gt, 6) == \
        jax_image.discover_palette(label, gt, 6)
    tfw = tmp_path / "a.tfw"
    tfw.write_text("0.5\n0\n0\n-0.5\n100.25\n200.75\n")
    assert image.read_tfw(str(tfw)) == jax_image.read_tfw(str(tfw))
    for shape, tile in (((64, 72, 4), 32), ((70, 45, 4), 16),
                        ((33, 65), 8)):
        x = rng.random(shape, dtype=np.float32)
        tiles, rows, cols = image.scene_to_tiles(x, tile)
        want, jr, jc = jax_image.scene_to_tiles(x, tile)
        assert (rows, cols) == (jr, jc) and np.array_equal(tiles, want)
        back = image.tiles_to_scene(tiles, rows, cols, shape[:2])
        assert np.array_equal(back, x)
        assert np.array_equal(back, jax_image.tiles_to_scene(
            want, rows, cols, shape[:2]))


@pytest.mark.parametrize("shape", [(5, 8, 9, 4), (3, 8, 9, 1), (2, 6, 7)])
def test_save_image_grid_pixels_equal(tmp_path, shape):
    """The port's grid, written without PIL, decodes to dmfusion's pixels."""
    x = np.random.default_rng(5).random(shape, dtype=np.float32) * 1.2 - 0.1
    save_image_grid(x, tmp_path / "port.png")
    jax_save_image_grid(x, str(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png").convert("RGB"))
    want = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"))
    assert got.shape == want.shape and np.array_equal(got, want)
