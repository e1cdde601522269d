"""Whole-scene map serving: a client asks for the class map of a scene,
map after map, through ``dmfusion_torch/export.py::TorchClassifier.
class_map`` (the dense family's ``DensePrograms.predict_map``).

Traffic keys: ``scenes`` (how many scenes the seed makes on the card at
set-up; request ``i`` maps scene ``i mod scenes``, so no map is an earlier
one's), ``loop`` (``closed``) with ``clients`` (1).  A request is timed
from the call until the (H, W) int32 map is on the host.

The check: a sample of the window's maps, drawn from the seed; for each,
the reference computes the logits of every pixel of its scene.
``label_gap`` compares the served map with them, ``logit_gap`` the logits
the served model computed for that map on its way to the labels: the
method that ``portbench/taps/<reference>.py`` names is wrapped on the
served model's instance, and the wrapper keeps what it returns.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import checks, flops, scenes, system, weights
from portbench.reference.common import exact, strict_float32
from portbench.sample import Reservoir


def setup(run) -> SimpleNamespace:
    c, t = run.config, run.traffic
    if t["loop"] != "closed" or t["clients"] != 1:
        raise ValueError(f"class_map drives one closed-loop client, not {t}")
    cfg = system.port_config(c, run.device)
    with run.spans.span("setup.scene"):
        made = [scenes.make(c["scene_size"], c["classes"], c["patch_size"],
                            system.DTYPES[c["scene_dtype"]], run.seed,
                            f"scene{i}", run.device)
                for i in range(int(t["scenes"]))]
    with run.spans.span("setup.model"):
        params = weights.make(system.param_spec(c), run.seed, run.device)
        weights.centre(params, system.reference(c), made[0], run.seed)
        clf = system.served_classifier(cfg, params, run.device)
    st = SimpleNamespace(scenes=made, scene=made[0], params=params, clf=clf,
                         next=0, logits=None,
                         kept=Reservoir(run.limits["sample"], run.seed))
    _tap(st, system.tap(c).METHOD)
    with run.spans.span("setup.warmup"):
        for i in range(int(t["warmup_units"])):
            s = made[i % len(made)]
            st.clf.class_map(s.ms, s.pan).cpu()
    return st


def _tap(st, method: str) -> None:
    """Keep what the served model's ``method`` returns, as ``st.logits``."""
    original = getattr(st.clf.model, method)

    def kept(*args, **kwargs):
        st.logits = original(*args, **kwargs)
        return st.logits
    setattr(st.clf.model, method, kept)
    st.untap = lambda: delattr(st.clf.model, method)


def unit(run, st, timed: bool = True, traced: bool = False) -> dict:
    i = st.next % len(st.scenes)
    st.next += 1
    s = st.scenes[i]
    t0 = time.perf_counter()
    with run.spans.span("map.class_map"):
        out = st.clf.class_map(s.ms, s.pan)
    with run.spans.span("map.to_host"):
        labels = out.cpu().numpy()
    latency = time.perf_counter() - t0
    logits, st.logits = st.logits, None
    # Shape and type here; the range, with everything else, in the check.
    ok = labels.shape == (s.height, s.width) and labels.dtype == np.int32
    if timed:
        st.kept.offer((i, labels, logits))
    return {"ok": ok, "latency_s": latency,
            "units": {"pixels": s.height * s.width, "requests": 1}}


def release(run, st) -> None:
    st.untap()
    st.clf = None


def reference_logits(run, st, i: int, q=exact) -> torch.Tensor:
    """(H, W, classes) reference logits of scene ``i``."""
    s = st.scenes[i]
    with torch.no_grad(), strict_float32():
        return system.reference(run.config).logits_map(
            st.params, *(t.float() for t in s.streams), s.patch, q)


def check(run, st) -> dict[str, float]:
    tap = system.tap(run.config)
    labels_gap, logits_gap = [], []
    for i, labels, logits in st.kept.kept:
        s, ref = st.scenes[i], reference_logits(run, st, i)
        labels_gap.append(checks.label_gap(ref, torch.from_numpy(labels)))
        logits_gap.append(checks.logit_gap(
            tap.logits_map(logits, s.height, s.width), ref))
        del ref
    return {"label_gap": max(labels_gap), "logit_gap": max(logits_gap)}


def unit_flops(run) -> int:
    """The reference's operations for one map's logits."""
    ref, s = system.reference(run.config), run.state.scene
    p = flops.meta_params(system.param_spec(run.config))
    return flops.count(lambda: ref.logits_map(
        p, *(flops.meta_like(t) for t in s.streams), s.patch))
