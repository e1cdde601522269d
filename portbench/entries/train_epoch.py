"""Training: epochs of the programs the port's solver picks for the
model's arity (``dmfusion_torch/models/registry.py::model_arity``), as it
runs them: ``dmfusion_torch/train/steps.py::DensePrograms.train_epoch``
for a dense model (whole-scene features, then every anchor's window
pooled), ``DualPrograms.train_epoch`` for a dual one (every batch's MS and
PAN windows gathered, then the per-anchor model).

Traffic keys: ``train_anchors`` (the train split's size: that many
labeled pixels drawn from the seed), ``shuffle`` (``each_epoch``: every
epoch a new permutation of them, from the seed, cut into batches of the
configuration's ``batchsize``, the last one padded and masked as the
solver pads it), ``first_steps`` and ``traced_steps``.  As in the port's
solver, the split and the permutations are drawn on the host (numpy) and
each epoch's ids, labels and mask go to the card once.  A unit of the
window is one whole epoch and its one loss fetch; the window's rate counts
the real (unpadded) anchors.

Set-up builds one model, optimizer and programs object (a dense model's
remat as the port's ``dense_remat_probe`` decides for ``dense_remat:
auto``; a dual model has none), and drives it through ``first_steps``
batches of an epoch with ``train_epoch`` itself: the epoch's first batch
(one call), then its second and its last (one call of two), the last
padded and masked as the solver pads it.  The same object then trains
through the window.  What the check compares is read then: each of those
steps' loss, the first step's gradient (Adam's first moment after one
step, over ``1 - beta1``), and the parameters' change over the steps.
The reference follows the same steps from the same weights with its own
Adam (its ``train_loss``), and once more computes the first step in
bfloat16, the configuration's compute dtype, to scale the first
gradient's rounding gap (``portbench/checks.py``).
"""

from __future__ import annotations

import math
import sys
from types import SimpleNamespace

import numpy as np
import torch

from portbench import checks, flops, scenes, system, weights
from portbench.reference.adam import Adam
from portbench.reference.common import bf16, exact, strict_float32
from portbench.seeds import numpy_rng


#: The model arities whose programs this entry drives.
ARITIES = ("dense", "dual")


def setup(run) -> SimpleNamespace:
    c, t, dev = run.config, run.traffic, run.device
    with run.spans.span("setup.import"):
        from dmfusion_torch.models.registry import model_arity
        arity = model_arity(c["model_name"])
        if arity == "dense":
            from dmfusion_torch.solvers.main import dense_remat_probe
        from dmfusion_torch.train.optim import make_optimizer
        from dmfusion_torch.train.steps import DensePrograms, DualPrograms

    if arity not in ARITIES:
        raise ValueError(f"train_epoch drives the programs of arities "
                         f"{ARITIES}; {c['model_name']} has arity {arity!r}")
    if t["shuffle"] != "each_epoch":
        raise ValueError(f"train_epoch shuffles each epoch, not {t}")
    cfg = system.port_config(c, dev)
    with run.spans.span("setup.scene"):
        scene = scenes.make(c["scene_size"], c["classes"], c["patch_size"],
                            system.DTYPES[c["scene_dtype"]], run.seed,
                            "scene0", dev)
    with run.spans.span("setup.model"):
        params = weights.make(system.param_spec(c), run.seed, dev)
        weights.centre(params, system.reference(c), scene, run.seed)
        model = system.model_with(cfg, params, dev)
    n_train, batch = int(t["train_anchors"]), int(c["batchsize"])
    if arity == "dense":
        remat = str(c.get("dense_remat", "auto"))
        if remat == "auto":
            with run.spans.span("setup.remat_probe"):
                remat = dense_remat_probe(cfg, system.port_scene(scene),
                                          model, n_train)["decision"]
        model.remat = remat != "off"
        print(f"[portbench] dense_remat {remat}", file=sys.stderr)
    with run.spans.span("setup.programs"):
        opt = make_optimizer(cfg, model.parameters(), -(-n_train // batch))
        if arity == "dense":
            programs = DensePrograms(model, scene.patch, optimizer=opt,
                                     cfg=cfg)
        else:
            programs = DualPrograms(model, opt, cfg, scene.width,
                                    scene.patch)
        flat = scene.label.reshape(-1).cpu().numpy().astype(np.int32)
        labeled = np.flatnonzero(flat).astype(np.int32)
        if labeled.shape[0] < n_train:
            raise ValueError(f"the scene has {labeled.shape[0]} labeled "
                             f"pixels, fewer than {n_train} train anchors")
        st = SimpleNamespace(
            scene=scene, params=params, model=model, opt=opt,
            programs=programs,
            n_train=n_train, batch=batch, labels_flat=flat,
            train_ids=numpy_rng(run.seed, "split").permutation(
                labeled)[:n_train],
            rng=numpy_rng(run.seed, "epochs"))
    with run.spans.span("setup.first_steps"):
        _first_steps(run, st, int(t["first_steps"]))
    return st


def _epoch(st, device):
    """One epoch's (steps, B) ids, labels and mask on ``device``, padded
    with id 0 and masked as the solver's ``batched_ids_np`` pads them."""
    n, b = st.n_train, st.batch
    steps = -(-n // b)
    ids = np.zeros(steps * b, np.int32)
    ids[:n] = st.rng.permutation(st.train_ids)
    mask = np.arange(steps * b) < n
    return tuple(torch.from_numpy(x.reshape(steps, b)).to(device)
                 for x in (ids, st.labels_flat[ids], mask.astype(np.float32)))


def _first_steps(run, st, k: int) -> None:
    """Drive the programs through an epoch's first ``k - 1`` batches and
    its last, padded one, and read what the check compares."""
    rows = list(range(k - 1)) + [-1]
    ids, labels, mask = (x[rows] for x in _epoch(st, run.device))
    scene_args = (st.scene.ms, st.scene.pan)
    named = list(st.model.named_parameters())
    losses = [st.programs.train_epoch(scene_args, ids[:1], labels[:1],
                                      mask[:1])]
    b1 = st.opt.param_groups[0]["betas"][0]
    grad = {n: st.opt.state[p]["exp_avg"] / (1.0 - b1) for n, p in named}
    losses.append(st.programs.train_epoch(scene_args, ids[1:], labels[1:],
                                          mask[1:]))
    delta = {n: p.detach() - st.params[n] for n, p in named}
    st.first = SimpleNamespace(ids=ids, labels=labels, mask=mask)
    st.prog = {"losses": torch.cat(losses).tolist(),
               "grad": checks.norms(grad), "delta": checks.norms(delta),
               "grad_tensors": grad}


def unit(run, st, timed: bool = True, traced: bool = False) -> dict:
    ids, labels, mask = _epoch(st, run.device)
    if not timed:
        k = int(run.traffic["traced_steps"])
        ids, labels, mask = ids[:k], labels[:k], mask[:k]
    real = min(st.n_train, ids.numel())
    with run.spans.span("train.train_epoch"):
        losses = st.programs.train_epoch((st.scene.ms, st.scene.pan), ids,
                                         labels, mask)
    with run.spans.span("train.fetch_loss"):
        loss = float(losses.mean())
    return {"ok": math.isfinite(loss),
            "units": {"samples": real, "steps": ids.shape[0]}}


def release(run, st) -> None:
    st.programs = st.model = st.opt = None


def reference_steps(run, st, q=exact, steps: int | None = None) -> dict:
    """The reference's losses, first gradient and change over the same
    first steps (or the first ``steps`` of them) from the same weights."""
    ref = system.reference(run.config)
    p = {n: v.detach().clone().requires_grad_(True)
         for n, v in st.params.items()}
    adam = Adam(p, float(run.config["lr"]))
    f, s = st.first, st.scene
    losses, grad, first = [], None, None
    for k in range(f.ids.shape[0] if steps is None else steps):
        with strict_float32():
            loss = ref.train_loss(p, *s.streams, s.patch, f.ids[k],
                                  f.labels[k], f.mask[k], q)
            g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        if grad is None:
            grad, first = checks.norms(g), g
        losses.append(float(loss.detach()))
        adam.step(p, g)
    delta = {n: p[n].detach() - st.params[n] for n in p}
    return {"losses": losses, "grad": grad, "delta": checks.norms(delta),
            "grad_tensors": first}


def check(run, st) -> dict[str, float]:
    return checks.train_gaps(st.prog, reference_steps(run, st),
                             reference_steps(run, st, bf16, steps=1))


def unit_flops(run) -> int:
    """The reference's forward and backward operations of one step."""
    ref, s = system.reference(run.config), run.state.scene
    p = flops.meta_params(system.param_spec(run.config), grad=True)
    b = int(run.config["batchsize"])
    ids = torch.zeros((b,), dtype=torch.int64, device=flops.META)
    labels = torch.zeros((b,), dtype=torch.int64, device=flops.META)
    mask = torch.ones((b,), device=flops.META)
    return flops.count(lambda: ref.train_loss(
        p, *(flops.meta_like(t) for t in s.streams), s.patch, ids, labels,
        mask).backward())
