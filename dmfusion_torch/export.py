"""Serving artifact of the port, and the reader for ``dmfusion`` ``.dmx`` files.

``save_artifact`` writes one zip of
  * ``manifest.json`` — the keys of ``dmfusion/export.py``'s manifest
    (model, arity, patch size, classes, city, palette, dtypes, seed),
    with ``torch_version`` in place of ``platforms``/``jax_version``, plus
    ``activate`` (and ``gmfnet_pan`` for gmfnet), which a ``.dmx`` bakes
    into its program instead; a dense artifact's unit is the whole padded
    scene, and it carries ``scene_shape`` and ``dense_bands`` as a dense
    ``.dmx`` does; so does a map export of gmfnet_conv (``map_route``,
    ``--map``), stamped ``serving: "map"`` with ``scene_shape`` and
    ``conv_bands``;
  * ``params.npz`` — the parameters under their flax tree paths
    (``ResBlock_2/Conv_0/kernel``) in flax layout, so the file is the
    same whichever framework reads it.

``load_artifact`` reads that zip or a ``.dmx`` written by the JAX package
(``manifest.json`` + ``params.msgpack``; its ``program.bin`` is StableHLO
for XLA and is ignored) and rebuilds the model from the manifest and the
widths its param tree gives (a ``.dmx`` records ``model_width`` but no
``trans``).  Per-anchor artifacts take arity ``dual`` (two inputs),
``tri`` (three: MS, PAN and the MSPAN stream that serving rebuilds from
the manifest's ``seed``), ``single`` (one: the MS window) or ``quad``
(one: dqtl's four MS-geometry streams concatenated on the batch axis,
served with the stage-1 GAN scenes).

    python -m dmfusion_torch.export --weights W.pt [--map] --out X.zip \
        [--config C] [--city CITY] [--model NAME] [--set key=value ...]

packages a checkpoint of the port's solver (``{time}_weights.pt``, whose
model and width stamp must match the config) as an artifact; it reads
and writes files only, on the host.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Mapping

import numpy as np
import torch

from dmfusion_torch.config import _deep_merge, load_config, resolve_device
from dmfusion_torch.models import build_model, model_arity
from dmfusion_torch.models.convert import load_flax_params, params_to_flax
from dmfusion_torch.models.registry import (get_model_class,
                                            model_map_programs)
from dmfusion_torch.trace import span
from dmfusion_torch.train.steps import (ConvMapPrograms, DensePrograms,
                                        fused_predict, resolve_conv_streams,
                                        resolve_dense_streams,
                                        resolve_dense_streams_infer)

ARTIFACT_FORMAT = 1

# PAN-geometry inputs after the MS window, by arity (dual: 1): tri adds
# MSPAN; single takes the MS window alone (dmfusion's input specs).
_PAN_INPUTS = {"tri": 2, "single": 0}

# flax's msgpack extension code for an ndarray (flax/serialization.py).
_EXT_NDARRAY = 1


def _dense_manifest_extras(cfg: Mapping[str, Any]) -> dict[str, Any]:
    """A dense artifact classifies one scene geometry: stamp it, and the
    band count of its class map (``dense_streams``/``_infer``)."""
    h, w, c = cfg["DATA_DICT"][cfg["data_city"]]["size"]
    ps = int(cfg["patch_size"])
    n_train = resolve_dense_streams(cfg.get("dense_streams", "auto"),
                                    h + ps - 1, w + ps - 1)
    bands = resolve_dense_streams_infer(
        cfg.get("dense_streams_infer", "auto"), n_train)
    return {"scene_shape": [int(h), int(w), int(c)],
            "dense_bands": int(bands)}


def _manifest(cfg: Mapping[str, Any], map_route: bool) -> dict[str, Any]:
    ps = int(cfg["patch_size"])
    h, w, chans = (int(v) for v in cfg["DATA_DICT"][cfg["data_city"]]["size"])
    prec = cfg.get("precision", {})
    arity = model_arity(cfg["model_name"])
    manifest = {
        "format": ARTIFACT_FORMAT,
        "model_name": cfg["model_name"],
        "arity": arity,
        "patch_size": ps,
        "model_width": int(cfg.get("model_width", 0)),
        "categories": int(cfg["Categories_Number"]),
        "data_city": cfg.get("data_city"),
        "palette": cfg["DATA_DICT"][cfg["data_city"]]["color"],
        "batch": "symbolic",
        "seed": int(cfg.get("seed", 0)),
        "compute_dtype": str(prec.get("compute_dtype", "bfloat16")),
        "scene_dtype": str(prec.get("scene_dtype", "float32")),
        "input_shapes": [["b", str(ps), str(ps), str(chans)]] + [
            ["b", str(4 * ps), str(4 * ps), "1"]]
        * _PAN_INPUTS.get(arity, 1),
        "torch_version": torch.__version__,
        "activate": str(cfg["schedule"]["activate"]),
    }
    if arity == "quad":
        # One input: the four streams' windows concatenated on the batch.
        manifest["input_shapes"] = [["4b", str(ps), str(ps), str(chans)]]
    if arity == "dense" or map_route:
        # The unit is the whole padded scene, as in dmfusion's export.
        manifest["batch"] = "scene"
        manifest["input_shapes"] = [
            [str(h + ps - 1), str(w + ps - 1), str(chans)],
            [str(4 * h + 4 * ps - 1), str(4 * w + 4 * ps - 1)]]
    if arity == "dense":
        manifest.update(_dense_manifest_extras(cfg))
    elif map_route:
        manifest["serving"] = "map"
        manifest["scene_shape"] = [h, w, chans]
        manifest["conv_bands"] = int(resolve_conv_streams(
            cfg.get("conv_streams", "auto"), h + ps - 1, w + ps - 1, ps,
            int(cfg.get("model_width", 64))))
    if str(cfg["model_name"]).lower() == "gmfnet":
        manifest["gmfnet_pan"] = str(cfg.get("gmfnet_pan", "s2d"))
    return manifest


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: v})
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def save_artifact(path: str | os.PathLike, cfg: Mapping[str, Any],
                  model: torch.nn.Module, *,
                  map_route: bool = False) -> dict[str, Any]:
    """Package ``model`` and its manifest into one zip at ``path``.
    ``map_route``: serve the whole-scene class map of a model with a
    convolutional map route (``MAP_PROGRAMS``, gmfnet_conv) instead of
    its per-anchor forward.  A model sharded over the mesh's model axis is
    packaged whole: its tree gathers the shards from its model peers
    (``params_to_flax``), so every peer calls this, and the artifact is a
    one-process model's.  A training run's checkpoints hold the whole
    model already, and ``main`` exports from them."""
    if map_route and model_map_programs(cfg["model_name"]) != "convmap":
        raise ValueError(
            f"--map: model {cfg['model_name']!r} has no convolutional map "
            "route (only MAP_PROGRAMS models, e.g. gmfnet_conv; the dense "
            "family exports its map by default)")
    manifest = _manifest(cfg, map_route)
    arrays = io.BytesIO()
    np.savez(arrays, **_flatten(params_to_flax(model)))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
        zf.writestr("params.npz", arrays.getvalue())
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return manifest


def _msgpack_restore(data: bytes) -> Any:
    """Decode flax's msgpack encoding of a param tree: ndarrays are
    extension values holding ``(shape, dtype name, raw bytes)``."""
    import msgpack

    def ext_hook(code: int, payload: bytes):
        if code != _EXT_NDARRAY:
            raise ValueError(f"unexpected msgpack extension type {code}")
        shape, dtype, buf = msgpack.unpackb(payload, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

    return msgpack.unpackb(data, ext_hook=ext_hook, raw=False)


def read_manifest(path: str | os.PathLike) -> dict[str, Any]:
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("manifest.json"))


class TorchClassifier:
    """A loaded artifact: ``manifest``, the config ``cfg`` it was rebuilt
    from, and the model on ``device``.  Per-anchor artifacts take NHWC
    window batches in ``logits(*inputs)`` and ``predict(*inputs)``: ``(ms,
    pan)`` for arity ``dual``, ``(ms, pan, mspan)`` for ``tri``, ``(ms,)``
    for ``single``, and for ``quad`` one ``(4b, ps, ps, C)`` batch of the four streams' windows,
    predicted by the fused MS-plus-PAN rule (``(b,)`` labels); map
    artifacts (arity ``dense``, or ``serving: "map"``) take the padded
    scene in ``logits(ms, pan)`` (the (H, W, ncls) map) and
    ``class_map(ms, pan)``."""

    def __init__(self, model: torch.nn.Module, manifest: dict[str, Any],
                 device: torch.device, cfg: Mapping[str, Any]):
        self.model = model
        self.manifest = manifest
        self.device = device
        self.cfg = cfg

    @property
    def is_map(self) -> bool:
        """True when the serving unit is the whole-scene class map: the
        dense family, or a map export of a ``MAP_PROGRAMS`` model."""
        return (self.manifest["arity"] == "dense"
                or self.manifest.get("serving") == "map")

    @torch.inference_mode()
    def logits(self, *inputs: torch.Tensor) -> torch.Tensor:
        ps = int(self.manifest["patch_size"])
        with span("model.forward"):
            if self.manifest["arity"] == "dense":
                return self.model(*inputs, ps)
            if self.is_map:
                return self.model.logits_map(*inputs, ps)
            return self.model(*inputs)

    def predict(self, *inputs: torch.Tensor) -> torch.Tensor:
        if self.is_map:
            raise ValueError("map artifacts classify whole scenes: call "
                             "class_map(ms, pan) with the padded scene")
        if self.manifest["arity"] == "quad":
            return fused_predict(self.logits(*inputs))
        return self.logits(*inputs).argmax(dim=-1).to(torch.int32)

    def class_map(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        """Map artifacts only: the (H, W) int32 class map of the padded
        scene, in the manifest's ``dense_bands`` (dense) or ``conv_bands``
        (map export) row bands; 0: one pass."""
        if not self.is_map:
            raise ValueError(f"class_map serves whole-scene artifacts; this "
                             f"one has arity {self.manifest['arity']!r}: use "
                             f"predict()")
        ps = int(self.manifest["patch_size"])
        with span("class_map"):
            if self.manifest["arity"] == "dense":
                with span("model.forward"):
                    return DensePrograms(self.model, ps).predict_map(
                        ms, pan, int(self.manifest.get("dense_bands", 0)))
            prog = ConvMapPrograms(self.model, None, self.cfg,
                                   int(self.manifest["scene_shape"][1]), ps)
            with span("model.forward"):
                return prog.predict_map(
                    ms, pan, int(self.manifest.get("conv_bands", 0)))


def load_artifact(path: str | os.PathLike,
                  device: torch.device | str | None = None,
                  overrides: Mapping[str, Any] | None = None) -> TorchClassifier:
    """Read the port's artifact or a ``dmfusion`` ``.dmx`` onto ``device``
    (default: ``resolve_device`` of the config, i.e. ``cuda:0`` unless
    ``overrides`` say ``device: cpu``; raises when there is no card).

    A ``.dmx`` does not record the activation its program bakes in: that
    comes only from ``overrides`` (e.g. ``{"schedule": {"activate":
    "Gelu"}}``), and without it the load raises.  The widths (and
    gmfnet's PAN branch, which a ``.dmx`` does not record either) are read
    from the param tree by the model class's ``widths_from_tree``.
    """
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        if manifest.get("format") != ARTIFACT_FORMAT:
            raise ValueError(
                f"{path}: artifact format {manifest.get('format')!r} is not "
                f"supported by this loader (expected {ARTIFACT_FORMAT})")
        names = zf.namelist()
        if "params.npz" in names:
            with np.load(io.BytesIO(zf.read("params.npz"))) as npz:
                tree = _unflatten({k: npz[k] for k in npz.files})
        elif "params.msgpack" in names:
            payload = _msgpack_restore(zf.read("params.msgpack"))
            tree = payload["tree"] if "tree" in payload else payload
        else:
            raise ValueError(f"{path}: no params.npz or params.msgpack")
    arity = manifest["arity"]
    if arity not in ("dual", "tri", "quad", "single", "dense"):
        raise ValueError(f"{path}: arity {arity!r} is not one of the "
                         f"serving arities ('dual', 'tri', 'quad', "
                         f"'single', 'dense')")
    act = manifest.get("activate") or (overrides or {}).get(
        "schedule", {}).get("activate")
    if act is None:
        raise ValueError(
            f"{path}: the artifact does not record its activation "
            f"(schedule.activate); pass it, e.g. overrides={{'schedule': "
            f"{{'activate': 'Relu'}}}} or --set schedule.activate=Relu")
    cfg_over: dict[str, Any] = {
        "model_name": manifest["model_name"],
        "data_city": manifest["data_city"],
        "patch_size": int(manifest["patch_size"]),
        "seed": int(manifest.get("seed", 0)),
        "schedule": {"activate": act},
        "precision": {"compute_dtype": manifest["compute_dtype"],
                      "scene_dtype": manifest.get("scene_dtype", "float32")},
    }
    if "scene_shape" in manifest:
        # A map artifact's city, even one outside DATA_DICT, is described
        # by the manifest itself.
        cfg_over["DATA_DICT"] = {manifest["data_city"]: {
            "size": manifest["scene_shape"], "color": manifest["palette"]}}
    cfg_over.update(get_model_class(manifest["model_name"])
                    .widths_from_tree(tree))
    if overrides:
        cfg_over = _deep_merge(cfg_over, overrides)
    cfg = load_config(overrides=cfg_over)
    model = load_flax_params(build_model(cfg), tree).eval()
    device = resolve_device(cfg) if device is None else torch.device(device)
    if device.type == "cuda":
        model = model.to(device, memory_format=torch.channels_last)
    return TorchClassifier(model, manifest, device, cfg)


def main(argv: list[str] | None = None) -> None:
    """Package a trained checkpoint of the port as an artifact; print one
    JSON line."""
    import argparse

    from dmfusion_torch.config import parse_overrides
    from dmfusion_torch.models.common import init_params
    from dmfusion_torch.train.checkpoint import load_checkpoint

    ap = argparse.ArgumentParser(prog="python -m dmfusion_torch.export")
    ap.add_argument("--config", default=None)
    ap.add_argument("--city", default=None)
    ap.add_argument("--model", default=None)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument("--weights", default=None,
                    help="the solver's best or current weights (.pt); "
                         "omit only with --random-init")
    ap.add_argument("--random-init", action="store_true",
                    help="export seeded parameters (smoke tests)")
    ap.add_argument("--map", action="store_true", dest="map_route",
                    help="export the whole-scene conv map route of a "
                         "MAP_PROGRAMS model (gmfnet_conv) instead of the "
                         "per-anchor forward")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.weights is None and not args.random_init:
        ap.error("--weights is required (or pass --random-init)")

    overrides = parse_overrides(args.set)
    if args.city:
        overrides["data_city"] = args.city
    if args.model:
        overrides["model_name"] = args.model
    cfg = load_config(args.config, overrides=overrides)
    model = init_params(build_model(cfg), torch.Generator().manual_seed(
        int(cfg.get("seed", 0))))
    if args.weights is not None:
        # The identity stamp the solver writes (``Solver._ckpt_meta``):
        # weights of another model or width are refused.
        state = load_checkpoint(
            args.weights, None, strict=True,
            expect={"model": str(cfg["model_name"]),
                    "width": int(cfg.get("model_width", 0) or 0)},
            lenient=bool(cfg.get("train", {}).get("pretrained_lenient")))
        # A current-weights file holds its parameters under "params"; a
        # missing or mis-shaped parameter raises.
        model.load_state_dict(state.get("params", state))
    manifest = save_artifact(args.out, cfg, model, map_route=args.map_route)
    print(json.dumps({"out": args.out, **{k: manifest[k] for k in (
        "model_name", "arity", "patch_size", "categories", "batch")},
        "serving": manifest.get("serving", "per_anchor")}))


if __name__ == "__main__":
    main()
