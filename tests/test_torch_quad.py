"""The quad arity of the port against dmfusion's, on the CPU in float32
(synth64, patch 8, width 8): the four MS-geometry streams, the four-stream
gather, dqtl and its converter, ``QuadPrograms`` and the per-stream
scores.

Both packages see the same seeded stage-1 scenes (``msgan.npy`` near
``pan2ms(PAN)``, ``pangan.npy`` near MS, each plus seeded noise), as
numpy arrays.  Tolerances:
  * the four streams: equal (the port's ``pan2ms`` block mean adds in
    dmfusion's order);
  * the gathers: bit-equal (the Pallas kernel in interpret mode on the
    in-scene anchors, edges included; ``gather_quad`` also on anchors past
    the scene, whose starts clamp as ``dynamic_slice``'s do);
  * the dqtl forward: atol 1e-5;
  * no argmax near-ties in the eval's logits (margins 1.9e-3 and more);
  * ``QuadPrograms``, one epoch of 3 steps under Adam, the last a partial
    batch, from the port's seeded weights carried to flax: the losses atol
    1e-5, chained over the epoch (largest reading 1.2e-7); each step again
    from JAX's state before it, as ``tests/test_torch_train.py`` holds
    ``DualPrograms``' second epoch: its loss, Adam moments and parameters
    atol 1e-5 (parameters 1.2e-7), the parameters excepted where the
    gradient is tiny (a conv bias before a GroupNorm) or the two packages'
    gradients part by more than ``GRAD_REL`` of JAX's (at most 1.0 % of
    the elements; the gradients part by at most 2.8e-8), and held there to
    Adam's step bound, ``2 * lr`` (largest reading 2.8e-4).  Chained, the
    parameters do not stay within 1e-5: Adam's first step moves every
    element by ``lr`` whatever its gradient's size, so elements whose
    gradient is rounding noise step apart, and the next step's gradients
    part by up to 2.5e-5 (12 % of the elements by more than ``GRAD_REL``);
  * eval loss sum rtol 1e-5, the five confusions and the predictions
    equal; the eval in chunks of batches sums to the whole eval (loss rtol
    1e-6, confusions equal).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data.patches import gather_quad as jax_gather_quad
from dmfusion.data.scene import prep_scene as jax_prep_scene
from dmfusion.data.scene import synthetic_scene as jax_synthetic_scene
from dmfusion.models import build_model as jax_build_model
from dmfusion.ops import pallas_gather
from dmfusion.ops.ihs import pan2ms as jax_pan2ms
from dmfusion.ops.metrics import per_stream_results as jax_per_stream_results
from dmfusion.report.excel import Workbook as JaxWorkbook
from dmfusion.report.excel import expo_stream_results as jax_expo_streams
from dmfusion.train.losses import make_loss as jax_make_loss
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import QuadPrograms as JaxQuadPrograms
from dmfusion_torch.config import load_config
from dmfusion_torch.data.patches import batched_ids_np, gather_quad
from dmfusion_torch.data.scene import quad_streams, synthetic_scene
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           opt_state_to_optax, params_to_flax)
from dmfusion_torch.ops import gather
from dmfusion_torch.ops.metrics import per_stream_results
from dmfusion_torch.report.excel import Workbook, expo_stream_results
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import QuadPrograms

OVER = {"data_city": "synth64", "model_name": "dqtl", "patch_size": 8,
        "model_width": 8, "batchsize": 32, "test_batchsize": 32,
        "color_batchsize": 32, "seed": 0, "nohup": 1,
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
LR, STEPS, TINY_GRAD, GRAD_REL = 1e-3, 3, 1e-7, 1e-3
BETA1 = 0.9  # optax.adam's first decay


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gan_scenes(raw_ms, raw_pan, size, seed=1):
    """Seeded stand-ins of stage 1's output: ``msgan`` (its fake PAN) near
    ``pan2ms(PAN)`` and ``pangan`` (its fake MS) near MS."""
    rng = np.random.default_rng(seed)
    pms = np.asarray(jax_pan2ms(jnp.asarray(raw_pan), size))
    msgan = pms + 0.1 * rng.standard_normal(pms.shape)
    pangan = raw_ms + 0.1 * rng.standard_normal(raw_ms.shape)
    return msgan.astype(np.float32), pangan.astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    jcfg = jax_load_config(overrides=OVER)
    jscene = jax_synthetic_scene(jcfg)
    size = (jscene.height, jscene.width, 4)
    msgan, pangan = gan_scenes(jscene.raw_ms, jscene.raw_pan, size)

    def prep(arr):
        return jax_prep_scene(jnp.asarray(np.asarray(arr, np.float32)),
                              jscene.patch, jnp.float32)

    jargs = (prep(jscene.raw_ms), prep(jax_pan2ms(jnp.asarray(
        jscene.raw_pan), size)), prep(msgan), prep(pangan))
    tscene = synthetic_scene(load_config(overrides=OVER), device="cpu")
    return {"jcfg": jcfg, "jscene": jscene, "jargs": jargs,
            "tscene": tscene, "gan": (msgan, pangan),
            "targs": quad_streams(tscene, msgan, pangan,
                                  torch.device("cpu"))}


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


def test_streams_equal_dmfusion(scenes):
    """MS, pan2ms(PAN), msgan and pangan, each normalized, padded and f32:
    the port's equal dmfusion's."""
    for got, want in zip(scenes["targs"], scenes["jargs"], strict=True):
        assert got.dtype == torch.float32 and got.shape == (71, 79, 4)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_gather_quad_bit_equal(scenes):
    """The port's ``gather_quad`` and ``gather_quad_fast`` (its plain
    version on the CPU, no launch) against dmfusion's ``gather_quad`` on 128
    anchors (corners, the last row and column, and 4 past the scene) and
    against ``gather_quad_fast(interpret=True)`` on the in-scene ones."""
    jscene = scenes["jscene"]
    n, w, h = jscene.num_pixels, jscene.width, jscene.height
    rng = np.random.default_rng(3)
    ids = rng.integers(0, n, 128).astype(np.int32)
    ids[:8] = [0, n - 1, w - 1, (h - 1) * w, n - 2, 2 * w - 1, n - w, 5 * w]
    ids[8:12] = [n, n + 5 * w + 3, 2 * n, n + w - 1]
    inside = ids < n
    want = jax_gather_quad(*scenes["jargs"], jnp.asarray(ids), w, 8)
    fast = pallas_gather.gather_quad_fast(*scenes["jargs"], jnp.asarray(ids),
                                          w, 8, interpret=True)
    t_ids = torch.from_numpy(ids)
    before = gather.gather_windows_cuda.launches
    got_plain = gather_quad(*scenes["targs"], t_ids, w, 8)
    got_fast = gather.gather_quad_fast(*scenes["targs"], t_ids, w, 8)
    assert gather.gather_windows_cuda.launches == before
    assert len(got_plain) == len(got_fast) == 4
    for p, f, jw, jf in zip(got_plain, got_fast, want, fast, strict=True):
        assert p.shape == f.shape == (128, 8, 8, 4)
        assert np.array_equal(p.numpy(), np.asarray(jw))
        assert np.array_equal(f.numpy(), np.asarray(jw))
        assert np.array_equal(f.numpy()[inside], np.asarray(jf)[inside])


def _inputs(b=3, seed=0):
    return np.random.default_rng(seed).random((4 * b, 8, 8, 4),
                                              dtype=np.float32)


def test_forward_matches_flax_and_round_trips():
    jm = jax_build_model(jax_load_config(overrides=OVER))
    x = _inputs(5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tree = _tree(params)
    model = load_flax_params(build_model(load_config(overrides=OVER)),
                             tree).eval()
    assert type(model).widths_from_tree(tree) == {"model_width": 8}
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (20, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = params_to_flax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.shape == b.shape and np.array_equal(a, b), back, tree))
    # gmfnet's tree, rooted at the same flax name, is refused.
    gm = jax_build_model(jax_load_config(overrides={**OVER,
                                                    "model_name": "gmfnet"}))
    gtree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), _tree(
        jax.eval_shape(gm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 32, 32, 1)))
        ["params"]))
    with pytest.raises(ValueError):
        load_flax_params(build_model(load_config(overrides=OVER)), gtree)


def _batches(label, rng, n, batch=32):
    labeled = np.flatnonzero(label.reshape(-1) != 0).astype(np.int32)
    ids = rng.choice(labeled, n, replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids, batch)
    labels = label.reshape(-1)[chunks].astype(np.int32)
    return chunks, labels, mask.astype(np.float32)


@pytest.fixture(scope="module")
def epoch(scenes):
    """One epoch of 3 steps (32 + 32 + 16 real anchors, 16 padded) in both
    packages from the same initial state, and each of its steps again in
    the port from JAX's state before it; eval and predict on JAX's trained
    weights."""
    jcfg, jscene = scenes["jcfg"], scenes["jscene"]
    tcfg = load_config(overrides=OVER)
    rng = np.random.default_rng(2)
    ep = _batches(jscene.label, rng, 80)
    evb = _batches(jscene.label, rng, 90)
    jprog = JaxQuadPrograms(jax_build_model(jcfg),
                            jax_make_optimizer(jcfg, STEPS), jcfg,
                            jscene.width, jscene.patch, None,
                            jax_make_loss("qua_loss", jcfg))
    # Seeded weights from the port's init, carried to flax: the programs
    # are held here, not the two inits.
    p0 = params_to_flax(init_params(build_model(tcfg),
                                    torch.Generator().manual_seed(2)))
    p = jax.tree.map(jnp.asarray, p0)
    o = jprog.tx.init(p)
    jsteps = []  # (state before, state after, loss, gradient) of each step
    for i in range(STEPS):  # one step a call, to read each gradient
        before = (_tree(p), _tree(o))
        p, o, loss = jprog.train_epoch(
            p, o, scenes["jargs"], *(jnp.asarray(a[i:i + 1]) for a in ep))
        after = (_tree(p), _tree(o))
        # optax's mu is BETA1 * mu0 + (1 - BETA1) * g: JAX's gradient.
        grad = (_vec(after[1]["0"]["mu"])
                - BETA1 * _vec(before[1]["0"]["mu"])) / (1 - BETA1)
        jsteps.append((before, after, float(loss[0]), grad))
    jp1 = serialization.from_state_dict(p, jsteps[-1][1][0])
    jeval = jprog.eval_epoch(jp1, scenes["jargs"], *map(jnp.asarray, evb))
    jpred = np.asarray(jprog.predict(jp1, scenes["jargs"],
                                     jnp.asarray(evb[0])))
    jlogits = np.asarray(jax.jit(lambda q, ids: jprog.apply(
        q, *jprog._gather(scenes["jargs"], ids)))(
            jp1, jnp.asarray(evb[0].reshape(-1))))

    ids, labels, mask = map(torch.from_numpy, ep)

    def port(params, opt_state, steps):
        model = load_flax_params(build_model(tcfg), params)
        opt = make_optimizer(tcfg, model.parameters(), STEPS)
        opt_state_from_optax(opt_state, model, opt)
        prog = QuadPrograms(model, opt, tcfg, jscene.width, jscene.patch)
        losses, grads = [], []
        for i in steps:  # one step a call, to read each gradient
            losses.append(prog.train_epoch(scenes["targs"], ids[i:i + 1],
                                           labels[i:i + 1], mask[i:i + 1]))
            grads.append(_vec(params_to_flax(
                model, {n: q.grad for n, q in model.named_parameters()})))
        return {"prog": prog, "losses": torch.cat(losses).numpy(),
                "grads": grads}

    return {"jsteps": jsteps, "chained": port(*jsteps[0][0], range(STEPS)),
            "each": [port(*st[0], [i]) for i, st in enumerate(jsteps)],
            "jp1": jsteps[-1][1][0], "eval": (evb, jeval, jpred, jlogits),
            "tcfg": tcfg}


def test_epoch_losses(epoch):
    """The port's losses, chained over the epoch and step by step from
    JAX's state, against JAX's."""
    want = np.array([st[2] for st in epoch["jsteps"]])
    assert np.isfinite(want).all() and want.min() > 0
    np.testing.assert_allclose(epoch["chained"]["losses"], want, rtol=0,
                               atol=1e-5)
    each = np.concatenate([t["losses"] for t in epoch["each"]])
    np.testing.assert_allclose(each, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("step", range(STEPS))
def test_epoch_step_moments_params(epoch, step):
    """One step from JAX's state: the update count and Adam's moments
    within 1e-5, the parameters within 1e-5 except where the gradient is
    tiny or the two packages' gradients part (then within Adam's step
    bound, 2 * lr)."""
    _, (params, opt_state), _, jg = epoch["jsteps"][step]
    t = epoch["each"][step]
    prog = t["prog"]
    got_o = opt_state_to_optax(prog.model, prog.optimizer)
    assert int(got_o["0"]["count"]) == int(opt_state["0"]["count"]) \
        == step + 1
    for key in ("mu", "nu"):
        np.testing.assert_allclose(_vec(got_o["0"][key]),
                                   _vec(opt_state["0"][key]), rtol=0,
                                   atol=1e-5, err_msg=key)
    g = t["grads"][0]
    excused = (np.abs(g) < TINY_GRAD) | (np.abs(g - jg) > GRAD_REL * np.abs(jg))
    assert excused.mean() < 0.1, f"{excused.mean():.3f} of elements excused"
    diff = np.abs(_vec(params_to_flax(prog.model)) - _vec(params))
    assert diff[~excused].max() <= 1e-5
    assert diff[excused].max(initial=0) <= 2 * LR


def _trained(epoch, scenes):
    model = load_flax_params(build_model(epoch["tcfg"]), epoch["jp1"])
    return QuadPrograms(model, None, epoch["tcfg"], scenes["tscene"].width,
                        scenes["tscene"].patch)


def test_eval_and_predict(epoch, scenes):
    evb, (jloss, jconfs), jpred, jlogits = epoch["eval"]
    streams = jlogits.reshape(4, -1, 5)  # the four streams' logits
    # No argmax near-ties, in the fused sum or in any stream.
    for lg in (streams[0] + streams[1], jlogits):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() >= 1e-4
    prog = _trained(epoch, scenes)
    loss, confs = prog.eval_epoch(scenes["targs"], *map(torch.from_numpy, evb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert confs.shape == (5, 5, 5)
    assert np.array_equal(confs.numpy(), np.asarray(jconfs))
    assert (confs.sum(dim=(1, 2)) == 90).all()  # the padding is masked out
    got = prog.predict(scenes["targs"], torch.from_numpy(evb[0]))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), jpred)
    conf = prog.test_confusion(scenes["targs"], *map(torch.from_numpy, evb))
    assert np.array_equal(conf.numpy(), np.asarray(jconfs)[0])


def test_eval_in_chunks_sums_to_whole(epoch, scenes):
    """The eval over batches of 8, run in chunks of 3 batches and summed,
    equals one eval over all of them (the port's analog of dmfusion's
    ``test_quad_chunked_eval_matches_monolithic``)."""
    prog = _trained(epoch, scenes)
    evb = _batches(scenes["jscene"].label, np.random.default_rng(4), 90,
                   batch=8)
    ids, labels, mask = map(torch.from_numpy, evb)
    assert ids.shape == (12, 8)
    whole = prog.eval_epoch(scenes["targs"], ids, labels, mask)
    parts = [prog.eval_epoch(scenes["targs"], ids[i:i + 3],
                             labels[i:i + 3], mask[i:i + 3])
             for i in range(0, 12, 3)]
    np.testing.assert_allclose(sum(float(p[0]) for p in parts),
                               float(whole[0]), rtol=1e-6)
    assert torch.equal(sum(p[1] for p in parts), whole[1])
    assert (whole[1].sum(dim=(1, 2)) == 90).all()


def test_streams_sheet_equals_dmfusion(tmp_path):
    """``per_stream_results`` and the workbook's ``streams`` sheet, from
    the same four matrices, equal dmfusion's, cell by cell."""
    rng = np.random.default_rng(6)
    mats = rng.integers(0, 30, (4, 5, 5)).astype(np.float32)
    mats[:, :, 0] = 0
    want = jax_per_stream_results(list(mats))
    got = per_stream_results(list(mats))
    assert got == want
    sheets = []
    for expo, wb_cls, results in ((jax_expo_streams, JaxWorkbook, want),
                                  (expo_stream_results, Workbook, got)):
        path = str(tmp_path / f"{len(sheets)}.xlsx")
        for repeat in (0, 1):
            expo(results, {"RESULT_excel": path}, repeat)
        sheet = wb_cls.load(path)["streams"]
        sheets.append([[sheet.cell(r, c) for c in range(1, 5)]
                       for r in range(1, 13)])
    assert sheets[0] == sheets[1]
    assert [row[0] for row in sheets[1][1:5]] == ["MS", "PAN", "GM", "GP"]
    assert sheets[1][7][0] == "MS" and os.path.isfile(path)
