"""Swin-T's window-attention cores (B6) at a served request: the kernel
against its plain version, timed on the card, and a served ``swin_t_dual``
request's launches and profiler linkage.

    python -m dmfusion_torch.tools.attn_probe [--batch 1024] [--ptxas]
                                              [--serve]
    python -m dmfusion_torch.tools.attn_probe --device cpu --batch 2

For each of Swin-T's four stage shapes (grids 56, 28, 14 and 7 of 96, 192,
384 and 768 channels in 3, 6, 12 and 24 heads of 32, window 7), unshifted
and shifted by 3 under its mask, it seeds a bf16 ``qkv`` grid of unit
spread and a bias table of unit spread, runs
``ops/attention.py::window_attn_cuda`` and ``window_attn_ref``, and
reports their largest gap, absolute and over the plain version's largest
value; over every anchor of the batch (TRUTH_ANCHORS at a time) it holds
both to a float64 truth (the same arithmetic, bf16's ``sqrt(32)``): the
kernel, whose scores stay in f32, must err no more on average than the
plain version, which rounds them to bf16, and at most twice its largest
error (both round p and the output to bf16), or it raises.  The same
holds over the first TRUTH_ANCHORS anchors alone.  Then it times, with CUDA
events in turns (median of 6 windows), the kernel, the plain version and
``F.scaled_dot_product_attention`` on the partitioned q, k and v with the
bias and mask as ``attn_mask`` (a yardstick only; the port never calls
it; the partition is not timed), beside the bytes bound (q, k, v read and
the output written once, the table and mask read once, at 3.35 TB/s), and
sums them over the 24 calls of a request (two encoders of 2-2-6-2
blocks, every second shifted).  The float32 body is held to the plain
version (TF32 off) at the first stage's shifted shape.

``--serve`` builds ``swin_t_dual`` at Swin-T's widths (patch 56, bf16,
seeded weights, an artifact round trip) over a seeded image6 scene and
serves requests of 1,024 anchors through ``ScenePredictor``: one request
must launch B6 24 times, 12 under a mask, none bypassed; B6's own device
time over one request (a CUDA-event pair around each launch) is held
against the device time ``key_averages()`` gives the ``swin.attn`` spans
of one profiled request (within LINK_TOL), and against the profiler's own
time of B6's kernels.  ``--ptxas`` builds ``csrc/window_attn.cu`` once
more with ``nvcc -Xptxas -v``.  On the CPU it runs the plain version at a
small batch and does not time.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
import time

import torch
import torch.nn.functional as F

from dmfusion_torch.config import load_config, resolve_device
from dmfusion_torch.models import swin
from dmfusion_torch.ops import attention
from dmfusion_torch.tools import (HBM_BYTES_PER_S, card_line, ptxas_report,
                                  time_in_turns)

WS, SHIFT = 7, 3
# (grid, channels, heads) a stage, and the calls a request makes of each
# unshifted and each shifted: depths 2-2-6-2, two encoders.
STAGES = [(56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24)]
CALLS = [2, 2, 6, 2]
SWIN_T = {"window_size": WS, "embed_dim": 96, "depths": [2, 2, 6, 2],
          "num_heads": [3, 6, 12, 24]}
#: The unit ``chip_smoke.py`` reports: the first stage's shifted call.
UNIT = (0, True)
TRUTH_ANCHORS = 16
LINK_TOL = 0.05
ROUNDS, WARMUP, ITERS = 3, 2, 10


def truth(qkv: torch.Tensor, table: torch.Tensor, mask, ws: int, shift: int,
          heads: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The core in float64, the scores divided by ``sqrt(hd)`` rounded to
    ``dtype`` as the port divides them (q scaled beforehand, exactly)."""
    c = qkv.shape[-1] // 3
    hd = c // heads
    x = qkv.double().clone()
    x[..., :c] *= math.sqrt(hd) / attention.score_divisor(hd, dtype)
    return attention.window_attn_ref(
        x, table.double(), None if mask is None else mask.double(), ws,
        shift, heads)


def core_bytes(b: int, h: int, w: int, c: int, heads: int, ws: int,
               masked: bool, elem_bytes: int) -> int:
    """The least bytes one core moves: q, k and v read and the output
    written once, the float32 table and mask read once."""
    table = (2 * ws - 1) ** 2 * heads * 4
    mask = (h // ws) * (w // ws) * ws ** 4 * 4 if masked else 0
    return 4 * b * h * w * c * elem_bytes + table + mask


def core_flops(b: int, h: int, w: int, c: int, ws: int) -> int:
    """The two products' operations of one core: ``2 n hd`` a query and
    key for q kᵀ and again for p v, over every window and head."""
    return 4 * b * h * w * ws * ws * c


def _mask(grid: int, shift: int, device) -> torch.Tensor | None:
    if not shift:
        return None
    return torch.from_numpy(swin._shift_mask(grid, grid, WS, shift)).to(
        device)


def library_inputs(qkv: torch.Tensor, table: torch.Tensor, mask,
                   shift: int, heads: int) -> tuple:
    """q, k, v partitioned from the grid and the bias (and mask) as one
    additive ``attn_mask`` that broadcasts over them, for
    ``F.scaled_dot_product_attention``."""
    b, h, w, c3 = qkv.shape
    hd, n = c3 // 3 // heads, WS * WS
    x = torch.roll(qkv, (-shift, -shift), dims=(1, 2)) if shift else qkv
    q, k, v = (t.contiguous() for t in attention.window_partition(x, WS)
               .reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4))
    rel = torch.from_numpy(attention.relative_index(WS).reshape(-1)).to(
        qkv.device)
    bias = table[rel].reshape(n, n, heads).permute(2, 0, 1)
    if mask is None:
        return q, k, v, bias.to(qkv.dtype).contiguous()
    nw = mask.shape[0]
    am = (bias[None] + mask[:, None]).to(qkv.dtype).reshape(nw * heads, n, n)
    return (*(t.reshape(b, nw * heads, n, hd) for t in (q, k, v)), am)


def _gaps(got, want, qkv, table, mask, shift, heads) -> dict:
    """The kernel's (``got``) and the plain version's (``want``) gap, and
    each one's error against :func:`truth`, over the whole batch
    (``truth_*``) and over its first TRUTH_ANCHORS anchors (``head_*``).
    Raises if the kernel errs more than the plain version on average, or
    more than twice its largest error, over either."""
    gap = float((got.float() - want.float()).abs().max())
    row = {"max_abs_err": gap,
           "max_rel_err": gap / float(want.float().abs().max())}
    sums, tops, count = [0.0, 0.0], [0.0, 0.0], 0
    for i in range(0, qkv.shape[0], TRUTH_ANCHORS):
        j = i + TRUTH_ANCHORS
        exact = truth(qkv[i:j], table, mask, WS, shift, heads)
        errs = [(t[i:j].double() - exact).abs() for t in (got, want)]
        if i == 0:
            row.update(head_mean_err=float(errs[0].mean()),
                       head_max_err=float(errs[0].max()),
                       plain_head_mean_err=float(errs[1].mean()),
                       plain_head_max_err=float(errs[1].max()))
        for k, e in enumerate(errs):
            sums[k] += float(e.sum())
            tops[k] = max(tops[k], float(e.max()))
        count += exact.numel()
        del exact, errs
    row.update(truth_mean_err=sums[0] / count, truth_max_err=tops[0],
               plain_truth_mean_err=sums[1] / count,
               plain_truth_max_err=tops[1])
    for part in ("truth", "head"):
        if not (row[f"{part}_mean_err"] <= row[f"plain_{part}_mean_err"]
                and row[f"{part}_max_err"]
                <= 2 * row[f"plain_{part}_max_err"]):
            raise RuntimeError(f"window_attn differs from the plain "
                               f"version: {row}")
    return row


def run(device: str | torch.device = "cuda", batch: int = 1024) -> dict:
    """Check each stage's core against the plain version and, on the card,
    time it.  Raises if a check fails, or without a card unless ``device``
    is cpu."""
    device = resolve_device({"device": str(device)})
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"device": str(device), "batch": batch, "cores": []}
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "launches": 0}
    for s, (grid, c, heads) in enumerate(STAGES):
        table = torch.randn(((2 * WS - 1) ** 2, heads), generator=gen,
                            device=device)
        for shifted in (False, True):
            shift = SHIFT if shifted else 0
            mask = _mask(grid, shift, device)
            qkv = torch.randn((batch, grid, grid, 3 * c), generator=gen,
                              device=device).to(torch.bfloat16)
            plan = attention.launch_plan(batch, grid, grid, c, heads, WS,
                                         shift, shifted, 2)
            row = {"stage": s + 1, "grid": grid, "channels": c,
                   "heads": heads, "masked": shifted, "launches": CALLS[s],
                   "plan": plan.as_ints()}
            with torch.inference_mode():
                want = attention.window_attn_ref(qkv, table, mask, WS, shift,
                                                 heads)
                if device.type != "cuda":
                    result["cores"].append(row)
                    continue
                got = attention.window_attn_cuda(qkv, table, mask, WS, shift,
                                                 heads)
                torch.cuda.synchronize()
                row.update(_gaps(got, want, qkv, table, mask, shift, heads))
                del got, want
                lib = library_inputs(qkv, table, mask, shift, heads)
                scale = 1 / attention.score_divisor(c // heads, qkv.dtype)
                runs = {"kernel": lambda _: attention.window_attn_cuda(
                            qkv, table, mask, WS, shift, heads),
                        "plain": lambda _: attention.window_attn_ref(
                            qkv, table, mask, WS, shift, heads),
                        "library": lambda _: F.scaled_dot_product_attention(
                            *lib[:3], attn_mask=lib[3], scale=scale)}
                med, _ = time_in_turns(runs, ITERS, ROUNDS, WARMUP)
                del lib
            moved = core_bytes(batch, grid, grid, c, heads, WS,
                                         shifted, 2)
            row.update(ms=med["kernel"], plain_ms=med["plain"],
                       library_ms=med["library"], moved_bytes=moved,
                       bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                       flops=core_flops(batch, grid, grid, c, WS))
            row["roofline_pct"] = 100 * row["bound_ms"] / row["ms"]
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                sums[k] += CALLS[s] * row[k]
            sums["launches"] += CALLS[s]
            result["cores"].append(row)
            if (s, shifted) == UNIT:
                result["unit"] = row
            del qkv
    if device.type == "cuda":
        result["request"] = sums
        result["f32"] = _f32_check(device, gen)
    return result


def _f32_check(device, gen) -> dict:
    """The float32 body against the plain version, TF32 off, at the first
    stage's shifted shape on 16 anchors."""
    grid, c, heads = STAGES[0]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        table = torch.randn(((2 * WS - 1) ** 2, heads), generator=gen,
                            device=device)
        qkv = torch.randn((16, grid, grid, 3 * c), generator=gen,
                          device=device)
        mask = _mask(grid, SHIFT, device)
        with torch.inference_mode():
            got = attention.window_attn_cuda(qkv, table, mask, WS, SHIFT,
                                             heads)
            want = attention.window_attn_ref(qkv, table, mask, WS, SHIFT,
                                             heads)
        err = float((got - want).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    if not err <= 1e-5:
        raise RuntimeError(f"window_attn f32 body differs from the plain "
                           f"version by {err}")
    return {"max_abs_err": err, "shape": [16, grid, grid, 3 * c]}


def serve(device: str | torch.device = "cuda", bucket: int = 1024,
          seed: int = 3407) -> dict:
    """A served ``swin_t_dual`` request at Swin-T's widths: B6's launches,
    its own device time against the profiler's ``swin.attn`` spans."""
    from torch.profiler import ProfilerActivity, profile

    from dmfusion_torch.data.scene import synthetic_scene
    from dmfusion_torch.export import load_artifact, save_artifact
    from dmfusion_torch.infer import ScenePredictor
    from dmfusion_torch.models import build_model
    from dmfusion_torch.models.common import init_params

    device = resolve_device({"device": str(device)})
    cfg = load_config(overrides={
        "data_city": "image6", "patch_size": 56, "seed": seed,
        "device": str(device), "model_name": "swin_t_dual", "trans": SWIN_T,
        "schedule": {"activate": "Gelu"},
        "precision": {"compute_dtype": "bfloat16", "scene_dtype": "float32"}})
    scene = synthetic_scene(cfg, device=device)
    model = init_params(build_model(cfg),
                        torch.Generator().manual_seed(seed))
    with tempfile.TemporaryDirectory() as tmp:
        save_artifact(f"{tmp}/swin_t_dual.zip", cfg, model)
        clf = load_artifact(f"{tmp}/swin_t_dual.zip", device)
    pred = ScenePredictor(clf, scene, bucket=bucket)
    g = torch.Generator().manual_seed(seed)
    reqs = [torch.randint(0, scene.num_pixels, (bucket,), generator=g,
                          dtype=torch.int32).numpy() for _ in range(6)]
    for r in reqs[:2]:
        pred.predict_ids(r)
    torch.cuda.synchronize()

    k = attention.window_attn_cuda
    counts = (k.launches, k.bypassed, swin.WindowAttention.calls,
              swin.WindowAttention.masked)
    t0 = time.perf_counter()
    pred.predict_ids(reqs[2])
    request_ms = (time.perf_counter() - t0) * 1e3
    launches, bypassed, calls, masked = (
        now - then for now, then in zip(
            (k.launches, k.bypassed, swin.WindowAttention.calls,
             swin.WindowAttention.masked), counts))
    if (launches, bypassed, calls, masked) != (24, 0, 24, 12):
        raise RuntimeError(f"a swin_t_dual request: {launches} B6 launches, "
                           f"{bypassed} bypassed, {calls} calls, {masked} "
                           f"masked; want 24, 0, 24, 12")

    # B6's own time: a CUDA-event pair around each launch of one request,
    # recorded on the launch's stream just before and after the C call.
    events = []
    kernel = attention._kernel

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = kernel()(*args)
        end.record()
        events.append((start, end))
        return err

    attention._kernel = lambda: timed
    try:
        pred.predict_ids(reqs[3])
    finally:
        attention._kernel = kernel
    torch.cuda.synchronize()
    event_ms = sum(s.elapsed_time(e) for s, e in events)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.predict_ids(reqs[4])
        torch.cuda.synchronize()
    avg = prof.key_averages()
    host = torch.autograd.DeviceType.CPU
    span_ms = sum(e.device_time_total for e in avg
                  if e.key == "swin.attn" and e.is_user_annotation
                  and e.device_type == host) / 1e3
    op_ms = sum(e.device_time_total for e in avg
                if e.key == "dmfusion_torch::window_attn"
                and e.device_type == host) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in avg
                    if "wattn_" in e.key and e.device_type != host) / 1e3
    model_ms = sum(e.device_time_total for e in avg
                   if e.key == "model.forward" and e.is_user_annotation
                   and e.device_type == host) / 1e3
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type != host) / 1e3
    top = sorted((e for e in avg if e.device_type != host),
                 key=lambda e: -e.self_device_time_total)[:12]
    out = {"bucket": bucket, "request_ms": request_ms,
           "launches": launches, "masked": masked, "bypassed": bypassed,
           "event_ms": event_ms, "event_launches": len(events),
           "span_device_ms": span_ms, "op_device_ms": op_ms,
           "kernel_device_ms": kernel_ms, "model_device_ms": model_ms,
           "device_busy_ms": busy,
           "span_vs_events": span_ms / event_ms - 1 if event_ms else None,
           "top_kernels_ms_calls": [[e.key[:80],
                                     e.self_device_time_total / 1e3, e.count]
                                    for e in top]}
    if not (len(events) == 24 and abs(span_ms - event_ms)
            <= LINK_TOL * event_ms):
        raise RuntimeError(f"the profiler's swin.attn device time is not "
                           f"B6's: {out}")
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args(argv)
    if args.ptxas:
        print(json.dumps({"ptxas": ptxas_report("window_attn")}), flush=True)
    result = run(args.device, args.batch)
    for row in result["cores"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "cores"}),
          flush=True)
    if args.serve:
        print(json.dumps({"serve": serve(args.device)}), flush=True)
    if result["device"].startswith("cuda"):
        print(card_line())


if __name__ == "__main__":
    main()
