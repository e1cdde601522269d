"""A/B of gmfnet_conv's two routes to a whole-scene class map: the
shift-and-stitch map route against the per-anchor route.

Port of ``tools/convmap_ab.py``.  On the synthetic scene of a city, with
seeded weights (or the caller's), it reports:

- the map route: ms per class map, labels on the host (median of
  ``repeats`` after ``warmup`` maps, whole or banded by ``conv_streams``),
  anchors/s over the scene, and the peak device memory of the maps;
- the per-anchor route: anchors/s over ``anchors`` random anchors through
  the window gather (B1 on the card) at batches of ``batch``, after one
  warm-up pass of the same batches, and the full map's time at that rate;
- argmax agreement of the two routes over the first ``parity_anchors`` of
  those anchors;
- with ``f32`` (TF32 off), the max abs logit gap of the two routes on them.

    python -m dmfusion_torch.tools.convmap_ab [city] [width] [patch]
    python -m dmfusion_torch.tools.convmap_ab image6 64 47 --f32
    python -m dmfusion_torch.tools.convmap_ab synth64 8 35 --device cpu \\
        --anchors 512 --parity-anchors 256 --batch 128

On the CPU it checks and does not time.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from typing import Any, Mapping

import numpy as np
import torch

from dmfusion_torch.config import load_config, resolve_device
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params
from dmfusion_torch.train.steps import ConvMapPrograms


def _wall(device: torch.device, fn) -> tuple[Any, float]:
    """``fn()`` and its wall seconds, the card drained before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _tf32_off(off: bool):
    """TF32 off for f32 convolutions and matmuls while ``off``; the flags
    are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if off:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def run(device: torch.device | str, city: str = "image6", width: int = 64,
        patch: int = 47, *, f32: bool = False, anchors: int = 98_304,
        parity_anchors: int = 32_768, batch: int = 4096,
        bands: str | int | None = None, warmup: int = 2, repeats: int = 10,
        state: Mapping[str, torch.Tensor] | None = None,
        scene=None, seed: int = 0) -> dict[str, Any]:
    """The A/B on ``device``; ``state`` (a state dict of the same model)
    replaces the seeded weights, ``scene`` the synthetic scene of
    ``city`` (it must be padded for ``patch``).  Returns the report."""
    device = torch.device(device)
    over: dict[str, Any] = {
        "data_city": city, "model_name": "gmfnet_conv", "model_width": width,
        "patch_size": patch, "seed": seed, "device": device.type,
        "precision": {"compute_dtype": "float32" if f32 else "bfloat16"}}
    if bands is not None:
        over["conv_streams"] = bands
    cfg = load_config(overrides=over)
    on_card = device.type == "cuda"
    if scene is None:
        scene = synthetic_scene(cfg, device=device)
    if int(scene.patch) != patch:
        raise ValueError(f"scene padded for patch {scene.patch}, not {patch}")
    model = init_params(build_model(cfg), torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict(state)
    model = model.to(device)
    if on_card:
        model = model.to(memory_format=torch.channels_last)
    prog = ConvMapPrograms(model, None, cfg, scene.width, patch)
    ms, pan = scene.ms, scene.pan
    cells = scene.num_pixels
    report: dict[str, Any] = {
        "city": city, "anchors_in_scene": cells, "patch": patch,
        "width": width, "compute": "float32" if f32 else "bfloat16",
        "bands": prog.conv_streams(ms.shape[0], ms.shape[1]),
        "device": torch.cuda.get_device_name(device) if on_card else "cpu"}
    n = anchors // batch * batch
    if n < 1:
        raise ValueError(f"{anchors} anchors make no batch of {batch}")
    ids = np.random.default_rng(seed).integers(0, cells, n).astype(np.int32)
    ids_b = torch.from_numpy(ids.reshape(-1, batch)).to(device)
    m = min(parity_anchors, n)

    with _tf32_off(f32):
        # The map route: warm-ups, then the timed maps (labels on the host).
        for _ in range(warmup if on_card else 0):
            _wall(device, lambda: prog.predict_map(ms, pan))
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        walls = []
        for _ in range(repeats if on_card else 1):
            cmap, sec = _wall(device, lambda: prog.predict_map(ms, pan).cpu())
            walls.append(sec)
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        # The per-anchor route: one warm-up pass of the same batches.
        if on_card:
            _wall(device, lambda: prog.predict((ms, pan), ids_b))
        preds, anchor_s = _wall(
            device, lambda: prog.predict((ms, pan), ids_b).cpu())
        report["agreement"] = float(
            (cmap.numpy().reshape(-1)[ids[:m]]
             == preds.numpy().reshape(-1)[:m]).mean())
        report["parity_anchors"] = m
        if f32:
            report["max_abs_logit_gap"] = _logit_gap(prog, scene, ids[:m],
                                                     batch)
    if not on_card:
        report["timed"] = "not measured: CPU run"
        return report
    map_s = statistics.median(walls)
    rate = n / anchor_s
    report.update({
        "map_ms": map_s * 1e3, "map_ms_all": [w * 1e3 for w in walls],
        "map_anchors_per_s": cells / map_s, "map_peak_bytes": int(peak),
        "per_anchor_anchors": n, "per_anchor_batch": batch,
        "per_anchor_s": anchor_s, "per_anchor_anchors_per_s": rate,
        "per_anchor_full_map_s": cells / rate,
        "speedup": (cells / rate) / map_s})
    return report


@torch.inference_mode()
def _logit_gap(prog: ConvMapPrograms, scene, ids: np.ndarray,
               batch: int) -> float:
    """Max abs gap between the map route's logits and the window route's
    at ``ids``."""
    model = prog.model.eval()
    lmap = model.logits_map(scene.ms, scene.pan, prog.patch)
    flat = lmap.reshape(-1, lmap.shape[-1])
    gap = 0.0
    for lo in range(0, ids.shape[0], batch):
        ids_t = torch.from_numpy(ids[lo:lo + batch]).to(scene.ms.device)
        win = model(*prog._gather((scene.ms, scene.pan), ids_t))
        gap = max(gap, float((win - flat[ids_t.long()]).abs().max()))
    return gap


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m dmfusion_torch.tools."
                                      "convmap_ab")
    ap.add_argument("city", nargs="?", default="image6")
    ap.add_argument("width", nargs="?", type=int, default=64)
    ap.add_argument("patch", nargs="?", type=int, default=47)
    ap.add_argument("--device", default=None,
                    help="default cuda:0 (raises without a card); 'cpu' "
                         "checks without timing")
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute, TF32 off: also report the max "
                         "logit gap of the two routes")
    ap.add_argument("--anchors", type=int, default=98_304)
    ap.add_argument("--parity-anchors", type=int, default=32_768)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--bands", default=None,
                    help="conv_streams for the map route (default auto)")
    args = ap.parse_args(argv)
    device = (torch.device(args.device) if args.device else
              resolve_device(load_config(overrides={"device": "cuda"})))
    print(json.dumps(run(device, args.city, args.width, args.patch,
                         f32=args.f32, anchors=args.anchors,
                         parity_anchors=args.parity_anchors,
                         batch=args.batch, bands=args.bands)))


if __name__ == "__main__":
    main()
