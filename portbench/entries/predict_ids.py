"""Per-anchor serving: a client classifies a scene request by request
through ``dmfusion_torch/infer.py::ScenePredictor.predict_ids``.

Traffic keys: ``anchors_per_request`` (also the predictor's bucket),
``draw``: ``uniform`` (every anchor drawn uniformly from all of the
scene's pixels, from the seed) or ``raster`` (consecutive flat ids,
request after request, from a start drawn from the seed and wrapping at
the scene's end, as ``class_map`` over ``np.arange`` and ``evaluate``
send them), and ``loop`` (``closed``) with ``clients`` (1): the next
request is sent when the last one's labels are on the host.  A request is
timed from the call until its labels are on the host: ids to the card,
the window gather, the model, the labels back.

The check: a sample of the window's requests, drawn from the seed; for
each, the reference computes the logits of every anchor from the same
scene and weights (its own plain gather).  ``label_gap`` compares the
served labels with them, ``logit_gap`` the logits the served model
returned for that request (kept by a forward hook on the served model,
which holds the output and computes nothing).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import checks, flops, scenes, system, weights
from portbench.reference.common import exact, strict_float32
from portbench.sample import Reservoir
from portbench.seeds import numpy_rng

REF_BLOCK = 2048


class Draws:
    """The anchors of successive requests of one stream of the seed."""

    def __init__(self, run, tag: str):
        self.kind = run.traffic["draw"]
        if self.kind not in ("uniform", "raster"):
            raise ValueError(f"unknown draw {self.kind!r}")
        self.n = int(run.config["scene_size"][0]) * int(
            run.config["scene_size"][1])
        self.b = int(run.traffic["anchors_per_request"])
        self.rng = numpy_rng(run.seed, tag)
        self.at = (int(self.rng.integers(0, self.n))
                   if self.kind == "raster" else 0)

    def next(self) -> np.ndarray:
        if self.kind == "uniform":
            return self.rng.integers(0, self.n, size=self.b, dtype=np.int32)
        ids = (self.at + np.arange(self.b, dtype=np.int64)) % self.n
        self.at = (self.at + self.b) % self.n
        return ids.astype(np.int32)


def setup(run) -> SimpleNamespace:
    with run.spans.span("setup.import"):
        from dmfusion_torch.infer import ScenePredictor

    c, t = run.config, run.traffic
    if t["loop"] != "closed" or t["clients"] != 1:
        raise ValueError(f"predict_ids drives one closed-loop client, "
                         f"not {t}")
    cfg = system.port_config(c, run.device)
    with run.spans.span("setup.scene"):
        scene = scenes.make(c["scene_size"], c["classes"], c["patch_size"],
                            system.DTYPES[c["scene_dtype"]], run.seed,
                            "scene0", run.device)
    with run.spans.span("setup.model"):
        params = weights.make(system.param_spec(c), run.seed, run.device)
        weights.centre(params, system.reference(c), scene, run.seed)
        clf = system.served_classifier(cfg, params, run.device)
    st = SimpleNamespace(
        scene=scene, params=params, clf=clf,
        predictor=ScenePredictor(clf, system.port_scene(scene),
                                 bucket=int(t["anchors_per_request"])),
        draws=Draws(run, "traffic"), logits=None, traced_ids=[],
        kept=Reservoir(run.limits["sample"], run.seed))
    st.hook = clf.model.register_forward_hook(
        lambda module, args, out: setattr(st, "logits", out))
    warm = Draws(run, "warmup")
    with run.spans.span("setup.warmup"):
        for _ in range(int(t["warmup_units"])):
            st.predictor.predict_ids(warm.next())
    return st


def unit(run, st, timed: bool = True, traced: bool = False) -> dict:
    ids = st.draws.next()
    t0 = time.perf_counter()
    with run.spans.span("serve.predict_ids"):
        labels = st.predictor.predict_ids(ids)
    latency = time.perf_counter() - t0
    logits, st.logits = st.logits, None
    # Shape and type here; the range, with everything else, in the check.
    ok = labels.shape == ids.shape and labels.dtype == np.int32
    if timed:
        st.kept.offer((ids, labels, logits))
    if traced:
        st.traced_ids.append(ids)
    return {"ok": ok, "latency_s": latency,
            "units": {"pixels": ids.shape[0], "requests": 1}}


def release(run, st) -> None:
    st.hook.remove()
    st.predictor = st.clf = None


def reference_logits(run, st, ids: np.ndarray, q=exact) -> torch.Tensor:
    """(n, classes) reference logits of the anchors ``ids``."""
    ref = system.reference(run.config)
    streams = tuple(t.float() for t in st.scene.streams)
    ids_t = torch.from_numpy(np.asarray(ids)).to(run.device)
    with torch.no_grad(), strict_float32():
        return torch.cat([
            ref.anchor_logits(st.params, *streams, ids_t[lo:lo + REF_BLOCK],
                              st.scene.width, st.scene.patch, q)
            for lo in range(0, ids_t.shape[0], REF_BLOCK)])


def check(run, st) -> dict[str, float]:
    labels_gap, logits_gap = [], []
    for ids, labels, logits in st.kept.kept:
        ref = reference_logits(run, st, ids)
        labels_gap.append(checks.label_gap(ref, torch.from_numpy(labels)))
        logits_gap.append(checks.logit_gap(logits, ref))
    return {"label_gap": max(labels_gap), "logit_gap": max(logits_gap)}


def unit_flops(run) -> int:
    """The reference's operations for one request's logits."""
    ref, s = system.reference(run.config), run.state.scene
    p = flops.meta_params(system.param_spec(run.config))
    ids = torch.empty((int(run.traffic["anchors_per_request"]),),
                      dtype=torch.int64, device=flops.META)
    return flops.count(lambda: ref.anchor_logits(
        p, *(flops.meta_like(t) for t in s.streams), ids, s.width, s.patch))
