"""Gather-only throughput: the strip kernel (B3) against the per-anchor
window gather (B1).

Port of ``tools/strip_gather_bench.py``.  It builds the image6 synthetic
scene (seed 0), lays strips of ``strip`` raster anchors on a fixed grid
(full strips per scene row, rows from the top), checks that the strip gather gives the same windows, bit for bit, as the
per-anchor gather ``gather_dual_fast`` on the same raster anchors, and on
the card times, with CUDA events and in turns:

- the strip gather on the raster anchors (two launches: MS and PAN);
- the per-anchor gather on the same raster anchors;
- the per-anchor gather on as many random anchors.

    python -m dmfusion_torch.tools.strip_gather_bench [--anchors N]
    python -m dmfusion_torch.tools.strip_gather_bench --device cpu \
        --size 48 128 4 --anchors 512 --strip 32 --patch 8

On the CPU it checks and does not time.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dmfusion_torch.config import load_config, resolve_device
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.ops.gather import gather_dual_fast
from dmfusion_torch.ops.strip_gather import gather_dual_strips
from dmfusion_torch.tools import card_line, time_in_turns

ROUNDS, WARMUP, ITERS = 3, 3, 10
CITY, SEED = "image6", 0


def strip_grid(height: int, width: int, patch: int, anchors: int,
               strip: int) -> tuple[np.ndarray, np.ndarray]:
    """Raster strips on a fixed grid: ``(width - patch + 1) // strip`` full
    strips per scene row, rows from the top; returns int32 ``xs``/``y0s``
    of ``anchors // strip`` strips."""
    n = anchors // strip
    per_row = (width - patch + 1) // strip
    if n < 1 or per_row < 1:
        raise ValueError(f"no full strip of {strip} anchors: {anchors} "
                         f"anchors, scene width {width}, patch {patch}")
    rows = -(-n // per_row)
    if rows > height:
        raise ValueError(f"{n} strips need {rows} rows; the scene has "
                         f"{height}")
    xs = np.repeat(np.arange(rows), per_row)[:n].astype(np.int32)
    y0s = np.tile(np.arange(per_row) * strip, rows)[:n].astype(np.int32)
    return xs, y0s


def strip_ids(xs: np.ndarray, y0s: np.ndarray, width: int,
              strip: int) -> np.ndarray:
    """The flat raster anchor ids of the strips, in output order."""
    return (xs[:, None].astype(np.int64) * width + y0s[:, None]
            + np.arange(strip)).reshape(-1).astype(np.int32)


def read_elements(view: torch.Tensor, xs: torch.Tensor, y0s: torch.Tensor,
                  rows: int, chans: int, span: int) -> int:
    """Elements of a 2-D ``view`` that strips with starts ``(xs, y0s)`` and
    slabs of ``rows`` x ``span`` pixels cover: what the gather must read."""
    covered = torch.zeros(view.shape, dtype=torch.bool, device=view.device)
    for x, y in zip(xs.tolist(), y0s.tolist()):
        covered[x:x + rows, y * chans:(y + span) * chans] = True
    return int(covered.sum())


def moved_bytes(ms: torch.Tensor, pan: torch.Tensor, xs: torch.Tensor,
                y0s: torch.Tensor, patch: int, strip: int) -> int:
    """Bytes a dual strip gather must move: every window written once,
    every covered scene element read once, and the starts."""
    c = ms.shape[-1]
    n = xs.shape[0]
    written = n * strip * (patch * patch * c + 16 * patch * patch)
    read = (read_elements(ms.reshape(ms.shape[0], -1), xs, y0s, patch, c,
                          strip - 1 + patch)
            + read_elements(pan, 4 * xs, 4 * y0s, 4 * patch, 1,
                            4 * (strip - 1) + 4 * patch))
    return (written + read) * ms.element_size() + 2 * n * 4


def run(device: str | torch.device = "cuda", anchors: int = 98_304,
        strip: int = 128, patch: int = 16,
        size: tuple[int, int, int] | None = None) -> dict:
    """Check the strip gather against the per-anchor gather and, on the
    card, time both; ``size`` replaces image6's (H, W, C).  Raises if
    the windows differ, or without a card unless ``device`` is cpu."""
    device = resolve_device({"device": str(device)})
    overrides = {"data_city": CITY, "patch_size": patch, "seed": SEED,
                 "device": str(device)}
    if size is not None:
        overrides["DATA_DICT"] = {CITY: {"size": list(size)}}
    scene = synthetic_scene(load_config(overrides=overrides), device=device)
    ps, width = scene.patch, scene.width
    xs_np, y0s_np = strip_grid(scene.height, width, ps, anchors, strip)
    xs = torch.from_numpy(xs_np).to(device)
    y0s = torch.from_numpy(y0s_np).to(device)
    ids = torch.from_numpy(strip_ids(xs_np, y0s_np, width, strip)).to(device)
    n = xs.shape[0]

    got = gather_dual_strips(scene.ms, scene.pan, xs, y0s, width, ps, strip)
    want = gather_dual_fast(scene.ms, scene.pan, ids, width, ps)
    for g, w, what in zip(got, want, ("MS", "PAN")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise RuntimeError(f"strip gather {what} windows differ from "
                               f"the per-anchor gather")
    calls = 1
    del got, want
    result = {"device": str(device), "city": CITY,
              "scene": [scene.height, width], "anchors": n * strip,
              "strips": n, "strip": strip, "patch": ps,
              "strips_per_row": int(len(set(y0s_np.tolist()))),
              "rows": int(xs_np.max()) + 1,
              "dtype": str(scene.ms.dtype).removeprefix("torch."),
              "bit_equal_to_per_anchor": True,
              "bytes": moved_bytes(scene.ms, scene.pan, xs, y0s, ps, strip)}
    if device.type == "cuda":
        rng = np.random.default_rng(SEED)
        rand = torch.from_numpy(rng.integers(0, scene.num_pixels, n * strip)
                                .astype(np.int32)).to(device)
        runs = {
            "strip": lambda i: gather_dual_strips(scene.ms, scene.pan, xs,
                                                  y0s, width, ps, strip),
            "per_anchor_raster": lambda i: gather_dual_fast(
                scene.ms, scene.pan, ids, width, ps),
            "per_anchor_random": lambda i: gather_dual_fast(
                scene.ms, scene.pan, rand, width, ps),
        }
        med, every = time_in_turns(runs, ITERS, ROUNDS, WARMUP)
        calls += 2 * ROUNDS * (WARMUP + ITERS)
        result.update({
            "gpu": torch.cuda.get_device_name(device), "ms": med,
            "anchors_per_s": {k: n * strip / v * 1e3 for k, v in med.items()},
            "ms_all": every})
    result["strip_calls"] = calls
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--anchors", type=int, default=98_304)
    ap.add_argument("--strip", type=int, default=128)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--size", type=int, nargs=3, metavar=("H", "W", "C"))
    args = ap.parse_args(argv)
    result = run(args.device, args.anchors, args.strip, args.patch,
                 tuple(args.size) if args.size else None)
    print(json.dumps(result))
    if result["device"].startswith("cuda"):
        print(card_line())


if __name__ == "__main__":
    main()
