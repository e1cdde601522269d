"""Serving-side scene inference from an artifact.

Port of ``dmfusion/infer.py`` for the ``dual``, ``tri``, ``quad``,
``single`` and ``dense`` arities.  ``ScenePredictor`` runs a loaded
classifier over a device-resident scene.  Per-anchor artifacts (``dual``;
``single``, the MS window alone; ``tri``, whose third stream, MSPAN, is
rebuilt from the scene and the manifest's seed as the solver builds it; ``quad``, whose four MS-geometry streams are built
from the scene and the stage-1 GAN scenes in ``gan_dir`` as the two-stage
solver builds them) gather windows (the CUDA kernel on the card, the
plain gather on the CPU) into fixed-size ``bucket`` batches;
map artifacts (``dense``, and a gmfnet_conv export with ``--map``) render
the whole-scene class map once and index it.  Both give argmax labels,
OA/AA/kappa against the scene labels and class maps.

    python -m dmfusion_torch.infer --artifact m.dmx [--set device=cpu] \
        [--gan-weights DIR] [--no-maps]

reads the port's artifact or a ``dmfusion`` ``.dmx`` and prints one JSON
line with metrics and wall times.  A ``.dmx`` does not record its
activation: the config's ``schedule.activate`` is used (``Relu`` unless
``--set schedule.activate=...`` says otherwise).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any

import numpy as np
import torch

from dmfusion_torch.data.scene import (load_gan_scenes, mspan_scene,
                                       quad_streams)
from dmfusion_torch.ops.gather import (gather_dual_fast, gather_one_fast,
                                       gather_quad_batch, gather_tri_fast)
from dmfusion_torch.trace import span


class ScenePredictor:
    """Per-anchor scene classification through a loaded classifier.

    ``dual``: the MS anchor (x, y) owns a ``ps`` window, the PAN anchor
    (4x, 4y) a ``4*ps`` window, as in training; ``single`` takes the MS
    window alone; ``tri`` adds the MSPAN
    window at the PAN anchor, from the MSPAN stream built with ``seed``
    (default: the manifest's, as the artifact was trained with); ``quad``
    gathers four windows at the MS anchor from the streams built with the
    GAN scenes in ``gan_dir`` (required; a missing file or an array of
    another scene's shape raises) and predicts by the fused rule; every
    chunk of anchors is padded to the one ``bucket`` size, so the model
    always sees one batch shape.  Map artifacts (``clf.is_map``:
    ``dense``, or ``serving: "map"``): the first query renders the
    whole-scene class map (one ``clf.class_map`` call, cached), and every
    query indexes it.
    """

    def __init__(self, clf, scene, *, bucket: int = 4096,
                 seed: int | None = None, gan_dir: str | None = None):
        arity = clf.manifest["arity"]
        if arity not in ("dual", "tri", "quad", "single", "dense"):
            raise ValueError(f"arity {arity!r} is not one of the serving "
                             f"arities ('dual', 'tri', 'quad', 'single', "
                             f"'dense')")
        if arity == "quad" and gan_dir is None:
            raise ValueError(
                "quad (DQTL) artifacts need the stage-1 GAN scene "
                "artifacts: pass gan_dir / --gan-weights pointing at the "
                "dir holding msgan.npy + pangan.npy (written by the "
                "two-stage solver's stage 1), or run the two-stage solver "
                "directly")
        if int(clf.manifest["patch_size"]) != int(scene.patch):
            raise ValueError(
                f"scene was padded for patch_size={scene.patch} but the "
                f"artifact expects {clf.manifest['patch_size']}")
        if scene.ms.device != clf.device:
            raise ValueError(f"scene is on {scene.ms.device} but the "
                             f"classifier on {clf.device}")
        if clf.is_map:
            # A map artifact is made for one scene geometry.
            want = clf.manifest.get("scene_shape")
            have = [scene.height, scene.width, int(scene.ms.shape[-1])]
            if want is not None and list(map(int, want)) != have:
                raise ValueError(
                    f"map artifact was exported for scene geometry "
                    f"{want} but this scene is {have} — wrong city?")
        self.clf = clf
        self.scene = scene
        self.bucket = int(bucket)
        self._map_cache: np.ndarray | None = None
        self.mspan = None
        self.streams, self.gather = (scene.ms, scene.pan), gather_dual_fast
        if arity == "tri":
            if seed is None:
                seed = int(clf.manifest.get("seed", 0) or 0)
            self.mspan = mspan_scene(scene, seed)
            self.streams += (self.mspan,)
            self.gather = gather_tri_fast
        elif arity == "quad":
            size = (scene.height, scene.width, int(scene.raw_ms.shape[-1]))
            self.streams = quad_streams(
                scene, *load_gan_scenes(gan_dir, size), clf.device)
            # dqtl takes the four streams on the batch axis: one buffer.
            self.gather = lambda *a: (gather_quad_batch(*a),)
        elif arity == "single":
            self.streams = (scene.ms,)
            self.gather = lambda ms, ids, w, ps: (
                gather_one_fast(ms, ids, w, ps),)

    def _map(self) -> np.ndarray:
        """Map artifacts: the whole-scene (H, W) class map from one
        ``class_map`` call, rendered once and cached; anchor queries index
        it."""
        if self._map_cache is None:
            dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
                str(self.clf.manifest.get("scene_dtype", "float32"))]
            s = self.scene
            out = self.clf.class_map(s.ms.to(dt), s.pan.to(dt))
            self._map_cache = out.cpu().numpy()[:s.height, :s.width]
        return self._map_cache

    def _gather(self, ids_b: torch.Tensor) -> tuple[torch.Tensor, ...]:
        with span("predict_ids.gather"):
            windows = self.gather(*self.streams, ids_b, self.scene.width,
                                  self.scene.patch)
            # bf16 scenes widen exactly to the model's f32 inputs.
            return tuple(w.float() for w in windows)

    def predict_ids(self, ids: np.ndarray) -> np.ndarray:
        """Flat anchor ids -> predicted class id per anchor."""
        with span("predict_ids"):
            ids = np.asarray(ids, np.int32)
            if self.clf.is_map:
                return np.asarray(self._map(), np.int32).reshape(-1)[ids]
            n = ids.shape[0]
            out = np.empty((n,), np.int32)
            b = self.bucket
            for lo in range(0, n, b):
                chunk = ids[lo:lo + b]
                k = chunk.shape[0]
                with span("predict_ids.ids_to_card"):
                    if k < b:  # pad to the one bucket shape
                        chunk = np.pad(chunk, (0, b - k))
                    ids_t = torch.from_numpy(chunk).to(self.clf.device)
                preds = self.clf.predict(*self._gather(ids_t))
                with span("predict_ids.labels_to_host"):
                    out[lo:lo + k] = preds[:k].cpu().numpy()
            return out

    def class_map(self, ids: np.ndarray | None = None) -> np.ndarray:
        """(H, W) int32 class map over ``ids`` (default: every pixel);
        anchors not in ``ids`` stay class 0."""
        s = self.scene
        if ids is None and self.clf.is_map:
            return self._map().copy()
        if ids is None:
            ids = np.arange(s.num_pixels, dtype=np.int32)
        label = np.zeros((s.height, s.width), np.int32)
        x, y = s.ids_to_xy(np.asarray(ids, np.int32))
        label[x, y] = self.predict_ids(ids)
        return label

    def evaluate(self, ids: np.ndarray | None = None) -> dict[str, Any]:
        """OA/AA/kappa over the scene's labeled pixels (or ``ids``)."""
        from dmfusion_torch.data.scene import split_labels
        from dmfusion_torch.ops.metrics import aa_oa, confusion_matrix

        if ids is None:
            ids, _ = split_labels(self.scene.label)
        ids = np.asarray(ids, np.int32)
        targets = self.scene.label.reshape(-1)[ids].astype(np.int32)
        ncls = int(self.clf.manifest["categories"])
        if targets.size and int(targets.max()) >= ncls:
            raise ValueError(
                f"scene labels reach class {int(targets.max())} but the "
                f"artifact has {ncls} classes — wrong city?")
        preds = self.predict_ids(ids)
        conf = confusion_matrix(torch.from_numpy(preds),
                                torch.from_numpy(targets), ncls).numpy()
        aa, oa, kap, _ = aa_oa(conf)
        return {"oa": oa, "aa": aa, "kappa": kap,
                "pixels": int(ids.shape[0]), "confusion": conf}


def main(argv: list[str] | None = None) -> None:
    """Classify a city scene with an artifact; print one JSON line."""
    from dmfusion_torch.config import load_config, parse_overrides, resolve_device
    from dmfusion_torch.data.scene import load_scene, split_labels
    from dmfusion_torch.export import load_artifact, read_manifest
    from dmfusion_torch.ops.metrics import render_class_map

    ap = argparse.ArgumentParser(prog="python -m dmfusion_torch.infer")
    ap.add_argument("--artifact", required=True,
                    help="the port's artifact or a dmfusion .dmx")
    ap.add_argument("--config", default=None)
    ap.add_argument("--city", default=None,
                    help="default: the artifact's data_city")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument("--bucket", type=int, default=4096)
    ap.add_argument("--gan-weights", default=None, metavar="DIR",
                    help="stage-1 GAN artifacts dir (msgan.npy + "
                         "pangan.npy); required for quad artifacts")
    ap.add_argument("--no-maps", action="store_true",
                    help="metrics only, skip map rendering")
    ap.add_argument("--out", default=None,
                    help="output dir (default: alongside the artifact)")
    args = ap.parse_args(argv)

    manifest = read_manifest(args.artifact)
    overrides = parse_overrides(args.set)
    overrides["data_city"] = args.city or manifest["data_city"]
    overrides["patch_size"] = int(manifest["patch_size"])
    # The synthetic scene is seed-derived and bf16 scenes gather other low
    # bits than f32 ones: default both to what the artifact was made with.
    if "seed" not in overrides and manifest.get("seed") is not None:
        overrides["seed"] = int(manifest["seed"])
    if manifest.get("scene_dtype"):
        overrides.setdefault("precision", {}).setdefault(
            "scene_dtype", manifest["scene_dtype"])
    cfg = load_config(args.config, overrides=overrides)
    device = resolve_device(cfg)

    model_over = None
    if "activate" not in manifest:  # a .dmx: the config names it
        model_over = {"schedule": {"activate": cfg["schedule"]["activate"]}}
    clf = load_artifact(args.artifact, device, overrides=model_over)

    t0 = time.perf_counter()
    scene = load_scene(cfg, device)
    pred = ScenePredictor(clf, scene, bucket=args.bucket,
                          gan_dir=args.gan_weights)
    labeled, _ = split_labels(scene.label)
    result: dict[str, Any] = {
        "artifact": args.artifact,
        "model": clf.manifest["model_name"],
        "city": cfg["data_city"],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "activate": clf.cfg["schedule"]["activate"],
        "pixels": int(scene.num_pixels),
    }
    metrics = pred.evaluate(labeled)
    metrics.pop("confusion")
    result.update(metrics)
    result["eval_s"] = round(time.perf_counter() - t0, 3)

    if not args.no_maps:
        from dmfusion_torch.report.png import write_png

        t1 = time.perf_counter()
        out_dir = args.out or (os.path.dirname(
            os.path.abspath(args.artifact)) or ".")
        os.makedirs(out_dir, exist_ok=True)
        palette = cfg["DATA_DICT"][cfg["data_city"]]["color"]
        if len(palette) != int(clf.manifest["categories"]):
            palette = clf.manifest["palette"]
        pal = torch.tensor(palette, dtype=torch.uint8)
        full = pred.class_map()
        sup = np.zeros_like(full)
        x, y = scene.ids_to_xy(labeled)
        sup[x, y] = full[x, y]
        stem = os.path.splitext(os.path.basename(args.artifact))[0]
        paths = []
        for tag, lab in (("1", sup), ("2", full)):
            img = render_class_map(torch.from_numpy(lab), pal).numpy()
            p = os.path.join(out_dir, f"{stem}_pic_{tag}.png")
            write_png(p, img)
            paths.append(p)
        result["maps"] = paths
        result["map_s"] = round(time.perf_counter() - t1, 3)

    print(json.dumps(result))


if __name__ == "__main__":
    main()
