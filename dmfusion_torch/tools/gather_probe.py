"""The window gather (B1) at the image6 shapes: every family call held
bit-equal to its plain version with one launch, then timed.

    python -m dmfusion_torch.tools.gather_probe [--ptxas] [--time-only]
    python -m dmfusion_torch.tools.gather_probe --device cpu

It seeds ``U(0, 1)`` scenes of the image6 geometry (MS ``(2016, 2116,
4)``, PAN and MSPAN ``(8067, 8467)``, four MS-geometry quad streams; at
patch 47 MS ``(2047, 2147, 4)``, PAN ``(8191, 8591)``) and holds every
family call (one, dual, tri, quad, the sharded dual) against its plain
version, bit for bit, with exactly one kernel launch a call: f32 and bf16
scenes, B 4096, the ragged 4093 and 256, patch 16 and 47, negative and
out-of-range ids, clamped explicit starts, and shards of 2 and 3 ranks
with a padded tail (:func:`check_calls`).  Then it times each family
call from the flat ids as the training and serving paths call it, beside
its plain version and one indexing call a stream, in turns with CUDA
events (:func:`time_call`), with the wrapper's host time a call and the
dual and quad buckets' profiler device time, and times on the host two
ways to make a call's outputs (one ``torch.empty`` a stream, or one
buffer cut into views).  ``--ptxas`` reports the kernels' registers and
spills.  The timing uses only the public wrappers (``gather_one_fast``,
``gather_dual_fast``, ``gather_tri_fast``, ``gather_quad_fast``,
``gather_dual_sharded``) and the plain gathers of ``data/patches.py``,
so ``--time-only`` also times an older tree's wrappers when the script
is copied into it.  On the CPU it checks the plain family version at a
small size and does not time.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from dmfusion_torch.config import resolve_device
from dmfusion_torch.data import patches
from dmfusion_torch.ops import gather as gather_ops
from dmfusion_torch.parallel.mesh import Mesh
from dmfusion_torch.tools import HBM_BYTES_PER_S, card_line, time_in_turns

# image6: 2001 x 2101 pixels.
H, W = 2001, 2101
BUCKET, TRAIN_BATCH = 4096, 256
ITERS = 50


def scenes(device, patch: int = 16, h: int = H, w: int = W,
           seed: int = 0) -> dict:
    """Seeded f32 scenes of the padded geometry at ``patch``: ``ms``,
    ``pan``, ``mspan`` and the four quad streams ``quad``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    ms_shape = (h + patch - 1, w + patch - 1, 4)
    pan_shape = (4 * h + 4 * patch - 1, 4 * w + 4 * patch - 1)
    return {"ms": u(*ms_shape), "pan": u(*pan_shape), "mspan": u(*pan_shape),
            "quad": tuple(u(*ms_shape) for _ in range(4))}


def families(s: dict) -> dict:
    """name -> (streams, plain gather, kernel wrapper, anchor scales)."""
    return {
        "one": ((s["ms"],), patches.gather_one, gather_ops.gather_one_fast,
                (1,)),
        "dual": ((s["ms"], s["pan"]), patches.gather_dual,
                 gather_ops.gather_dual_fast, (1, 4)),
        "tri": ((s["ms"], s["pan"], s["mspan"]), patches.gather_tri,
                gather_ops.gather_tri_fast, (1, 4, 4)),
        "quad": (s["quad"], patches.gather_quad, gather_ops.gather_quad_fast,
                 (1, 1, 1, 1)),
    }


def _tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def anchor_ids(n: int, batch: int, width: int, rng,
               wild: bool = False) -> np.ndarray:
    """``batch`` int32 ids in ``[0, n)`` with the corner anchors and the
    last row and column; ``wild`` also puts negative ids and ids past
    ``n`` at the front."""
    ids = rng.integers(0, n, batch).astype(np.int32)
    h = n // width
    edge = [0, n - 1, width - 1, (h - 1) * width, n - width, 2 * width - 1]
    if wild:
        edge += [-1, -width, -width - 1, -n, -n - 7, n, n + width + 3,
                 2**31 - 1, -2**31, 10**9]
    ids[:len(edge)] = edge[:batch]
    return ids


def check_calls(s: dict, width: int, patch: int, device, log: Callable,
                batches=(BUCKET, BUCKET - 3, TRAIN_BATCH),
                dtypes=(torch.float32, torch.bfloat16), seed: int = 0
                ) -> float:
    """Every family call of ``families(s)`` against its plain version:
    bit-equal, one launch a call (none on the CPU), at each batch and
    dtype; negative and out-of-range ids; a stand-in mesh of 2 and 3 ranks
    at B 4160 (a padded tail) through ``shard=``; returns the largest
    difference seen (0.0)."""
    rng = np.random.default_rng(seed)
    n = (s["ms"].shape[0] - patch + 1) * width
    on_card = torch.device(device).type == "cuda"
    worst = 0.0

    def one_call(name, streams, plain, fast, ids, tag, shard=None):
        nonlocal worst
        before = gather_ops.gather_windows_cuda.launches
        got = _tuple(fast(*streams, ids, width, patch, shard))
        launched = gather_ops.gather_windows_cuda.launches - before
        if launched != int(on_card):
            raise RuntimeError(f"{name} {tag}: {launched} launches")
        want = _tuple(plain(*streams, gather_ops.shard_ids(ids, shard),
                            width, patch))
        for g, r in zip(got, want, strict=True):
            if g.dtype != r.dtype or g.shape != r.shape:
                raise RuntimeError(f"{name} {tag}: {g.dtype} {tuple(g.shape)}"
                                   f" != {r.dtype} {tuple(r.shape)}")
            err = float((g.float() - r.float()).abs().max()) if g.numel() else 0.0
            worst = max(worst, err)
            if not torch.equal(g, r):
                raise RuntimeError(f"{name} {tag}: kernel != plain (max "
                                   f"{err})")

    for dt in dtypes:
        cast = {k: (tuple(t.to(dt) for t in v) if k == "quad" else v.to(dt))
                for k, v in s.items()}
        fams = families(cast)
        for batch in batches:
            ids = torch.from_numpy(anchor_ids(n, batch, width, rng)).to(device)
            for name, (streams, plain, fast, _) in fams.items():
                one_call(name, streams, plain, fast, ids, f"{dt} B={batch}")
        wild = torch.from_numpy(anchor_ids(n, 64, width, rng, wild=True)
                                ).to(device)
        for name, (streams, plain, fast, _) in fams.items():
            one_call(name, streams, plain, fast, wild, f"{dt} wild ids")
        ids = torch.from_numpy(anchor_ids(n, 4160, width, rng)).to(device)
        for data in (2, 3):
            for rank in range(data):
                mesh = Mesh(data=data, rank=rank, device=torch.device(device),
                            backend="none")
                shard = mesh.shard_rows(ids.shape[0])
                for name, (streams, plain, fast, _) in fams.items():
                    one_call(name, streams, plain, fast, ids,
                             f"{dt} rank {rank} of {data}", shard)
                got = gather_ops.gather_dual_sharded(
                    *fams["dual"][0], ids, width, patch, mesh)
                want = patches.gather_dual(*fams["dual"][0], mesh.shard(ids),
                                           width, patch)
                if not all(torch.equal(g, r) for g, r in zip(got, want)):
                    raise RuntimeError(f"gather_dual_sharded {dt} rank "
                                       f"{rank} of {data} != plain")
        del cast, fams
    log(f"gather_probe: every family call bit-equal at patch {patch}, "
        f"{len(dtypes)} dtypes, B {batches}, wild ids, shards of 2 and 3 "
        f"ranks; one launch a call")
    if on_card:
        # Explicit starts: clamped and negative, on every stream geometry.
        for view, p, chans in (
                (s["ms"].reshape(s["ms"].shape[0], -1), patch, 4),
                (s["pan"], 4 * patch, 1)):
            hi_r, hi_c = view.shape[0] + 5, view.shape[1] // chans + 5
            xs = torch.tensor([-1, -hi_r, 0, hi_r, 10**9, 3, -7],
                              dtype=torch.int32, device=device)
            ys = torch.tensor([0, 5, -hi_c, -1, 10**9, hi_c, -3],
                              dtype=torch.int32, device=device)
            if not torch.equal(
                    gather_ops.gather_windows_cuda(view, xs, ys, p, chans),
                    gather_ops.gather_windows_ref(view, xs, ys, p, chans)):
                raise RuntimeError(f"clamped explicit starts, patch {p}")
    return worst


def moved_bytes(streams: tuple, scales: tuple, rows: int, patch: int) -> int:
    """The bound's bytes: every window read once and written once (``rows``
    of them a stream), and the ``rows`` int32 ids read once."""
    out = sum(rows * (patch * k) ** 2 * (t.shape[-1] if t.ndim == 3 else 1)
              * t.element_size() for t, k in zip(streams, scales))
    return 2 * out + 4 * rows


def device_ms(fn: Callable[[int], object], calls: int = 20) -> float:
    """The profiler's device time of the window kernels a call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if "gather_" in e.key and "kernel" in e.key)
    return us / 1e3 / calls


def host_ms(fn: Callable[[int], object], calls: int = 50) -> float:
    """Host milliseconds a call of ``fn``: the time to enqueue ``calls``
    calls on an idle card, before the synchronise."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def time_call(streams: tuple, plain, fast, scales: tuple, width: int,
              patch: int, batch: int, rng, *, mesh=None, iters: int = ITERS,
              profile: bool = False) -> dict:
    """Time one family call of ``batch`` anchors from the flat ids, as the
    main path makes it: the kernel wrapper ``fast``, the plain version
    ``plain`` and one indexing call a stream (``library``: index grids
    precomputed), in turns; with ``mesh``, this rank's shard of each batch
    (``gather_dual_sharded``'s contract).  Returns the medians (ms), the
    bytes bound, every window, the host ms a kernel call and, with
    ``profile``, the profiler's device ms a kernel call."""
    device = streams[0].device
    n = (streams[0].shape[0] - patch + 1) * width
    # Eight anchor sets in turn so consecutive calls do not reuse L2 lines.
    sets = [torch.from_numpy(rng.integers(0, n, batch).astype(np.int32)
                             ).to(device) for _ in range(8)]
    pick = (lambda ids: ids) if mesh is None else mesh.shard

    def grids(ids):
        ids = pick(ids).long()
        x, y = ids // width, ids % width
        out = []
        for t, k in zip(streams, scales):
            t3 = t if t.ndim == 3 else t[..., None]
            c, win = t3.shape[-1], patch * k
            v = t3.reshape(t3.shape[0], -1)
            out.append((v, (k * x[:, None] + torch.arange(win, device=device)
                            )[:, :, None],
                        (k * y[:, None] * c + torch.arange(win * c,
                                                           device=device)
                         )[:, None, :]))
        return out

    index = [grids(ids) for ids in sets]
    if mesh is None:
        kernel = lambda i: fast(*streams, sets[i % 8], width, patch)  # noqa: E731
    else:
        kernel = lambda i: fast(*streams, sets[i % 8], width, patch, mesh)  # noqa: E731
    runs = {"plain": lambda i: plain(*streams, pick(sets[i % 8]), width,
                                     patch),
            "kernel": kernel,
            "library": lambda i: [v[r, c] for v, r, c in index[i % 8]]}
    med, every = time_in_turns(runs, iters)
    rows = batch if mesh is None else mesh.per_rank(batch)
    moved = moved_bytes(streams, scales, rows, patch)
    out = {"ms": med["kernel"], "plain_ms": med["plain"],
           "library_ms": med["library"],
           "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "moved_bytes": moved, "host_ms": host_ms(kernel), "all": every}
    if profile:
        out["device_ms"] = device_ms(kernel)
    return out


def time_all(s: dict, s47: dict, rng, log: Callable) -> dict:
    """Every family call at its main-path shapes (f32 scenes)."""
    fams = families(s)
    out = {}
    for name, (streams, plain, fast, scales) in fams.items():
        for batch in (BUCKET, TRAIN_BATCH):
            out[f"{name} B{batch}"] = time_call(
                streams, plain, fast, scales, W, 16, batch, rng,
                profile=name in ("dual", "quad"))
    d47 = families(s47)["dual"]
    for batch in (BUCKET, TRAIN_BATCH):
        out[f"dual patch47 B{batch}"] = time_call(
            d47[0], d47[1], d47[2], d47[3], W, 47, batch, rng)
    dual = fams["dual"]
    for batch in (BUCKET, 4160):
        mesh = Mesh(data=2, rank=0, device=s["ms"].device, backend="none")
        out[f"sharded B{batch}"] = time_call(
            dual[0], patches.gather_dual, gather_ops.gather_dual_sharded,
            dual[3], W, 16, batch, rng, mesh=mesh)
    for k, v in out.items():
        log(f"gather_probe: {k}: kernel {v['ms']:.4f} ms (host "
            f"{v['host_ms']:.4f}"
            + (f", device {v['device_ms']:.4f}" if "device_ms" in v else "")
            + f") plain {v['plain_ms']:.4f} library {v['library_ms']:.4f} "
            f"bound {v['bound_ms']:.4f} ({v['moved_bytes'] / 1e6:.1f} MB, "
            f"{v['bound_ms'] / v['ms']:.0%})")
    return out


def alloc_ab(device, calls: int = 2000) -> dict:
    """Host microseconds to make a dual call's outputs at B 4096: one
    ``torch.empty`` a stream, or one buffer cut into views."""
    shapes = [(BUCKET, 16, 16, 4), (BUCKET, 64, 64, 1)]
    sizes = [int(np.prod(s)) for s in shapes]

    def per_stream():
        return [torch.empty(s, device=device) for s in shapes]

    def one_buffer():
        buf = torch.empty(sum(sizes), device=device)
        return [buf[o:o + k].view(s) for o, k, s in
                zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes, shapes)]

    out = {}
    for name, fn in (("per_stream", per_stream), ("one_buffer", one_buffer)) * 2:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def run(device: str | torch.device = "cuda", time_only: bool = False,
        log: Callable = print) -> dict:
    """Check every family call and, on the card, time them.  Raises if a
    check fails, or without a card unless ``device`` is cpu."""
    device = resolve_device({"device": str(device)})
    result = {"device": str(device)}
    if device.type != "cuda":
        small = scenes(device, 8, 20, 24)
        result["max_abs_err"] = check_calls(small, 24, 8, device, log,
                                            batches=(64, 61))
        return result
    rng = np.random.default_rng(0)
    s = scenes(device, 16)
    s47 = scenes(device, 47, seed=1)
    if not time_only:
        result["max_abs_err"] = max(
            check_calls(s, W, 16, device, log),
            check_calls(s47, W, 47, device, log,
                        batches=(BUCKET, TRAIN_BATCH)))
    result["gpu"] = torch.cuda.get_device_name(device)
    result["times"] = time_all(s, s47, rng, log)
    if not time_only:
        result["alloc_us"] = alloc_ab(device)
        log(f"gather_probe: output allocation, host us a dual call: "
            f"{json.dumps(result['alloc_us'])}")
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    result = run(args.device, args.time_only)
    if args.ptxas:
        from dmfusion_torch.tools import ptxas_report
        result["ptxas"] = ptxas_report("gather_windows")
    print(json.dumps(result))
    if result["device"].startswith("cuda"):
        print(card_line())


if __name__ == "__main__":
    main()
