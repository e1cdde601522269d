"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:
  1. device   — require CUDA, print ``nvidia-smi`` name and power limit;
  2. build    — build every kernel of the served paths from
                ``dmfusion_torch/csrc`` (nvcc, sm_90a), print the seconds;
  3. kernels  — hold each kernel against its plain PyTorch version at the
                main path's shapes (image6 synthetic scene, patch 16): the
                window gather must be bit-equal for f32 and bf16 scenes, a
                4096 bucket, an odd batch, corner and clamped anchors; time
                the kernel, the plain version and one PyTorch indexing
                call, and compute the bytes bound;
  4. serving  — gmfnet at width 64, bf16 compute, f32 scene, seeded
                weights, saved and loaded as an artifact, serving
                bucket-4096 requests through ``ScenePredictor``; the
                launch counts must show the kernel ran twice per bucket;
                predictions must equal a run with the plain gather; the
                norms must hand bf16 on, as flax's GroupNorm(dtype=bf16)
                does; the bf16 logits on the card must lie within
                BF16_ATOL of the f32 logits of the same weights on the CPU,
                and f32 logits on the card (TF32 off) within 1e-3;
  5. pool     — the phase window-pool must be bit-equal to its plain
                version at the image6 w32 shape (bf16 and f32), at an
                odd-output geometry, at a wide one (4C = 256, patch 32),
                at patch 34 (the shared body) and at 24-byte pixels
                (4C = 12, bf16); print the launch plan; time the kernel,
                the plain version and one ``avg_pool2d`` call on the
                full-resolution map, and compute the bytes bound;
  6. dense    — dense_fusion at width 32, patch 16, bf16 compute, f32
                scene, seeded weights, saved and loaded as an artifact,
                rendering the whole image6 class map through
                ``ScenePredictor.class_map()``: 2 warm-up and 10 timed
                maps, one pool launch per map; the map with the plain pool
                on the card must be equal; ``evaluate()``; a map in 4 row
                bands (4 launches, argmax agreement >= 0.999 with the
                whole map); on a 96x96 crop, bf16 card logits within
                DENSE_BF16_ATOL of f32 CPU logits and f32 card logits
                (TF32 off) within 1e-3; a profile of 2 maps;
  7. strip    — the strip gather must be bit-equal to its plain version
                at the strip bench's shape (98,304 image6 raster anchors,
                strips of 128, patch 16) in f32 and bf16, and at edge
                strips past the right and the bottom edge of the view
                (zeros) with starts off any alignment; two launches per
                dual strip call; then ``strip_gather_bench.run()`` on the
                card (bit-equal to the per-anchor gather, timed against
                it); time the kernel, the plain version and one indexing
                call per view, and compute the bytes bound;
  8. conv     — the built kernel's SASS must hold wgmma (HGMMA) and
                bulk copies (UBLKCP) and no mma.sync (HMMA); the 3x3
                128->128 bf16 conv must be equal or one bf16 ulp apart
                (``ulp_report``) from its plain version and from
                ``F.conv2d`` at odd shapes and at shapes on and off the
                8 x 32 tile, and equal the closed form of a constant-weight
                case, one launch per pass; then ``conv_kernel_probe.run()``
                at the dense trunk's (1008, 1058, 128), which checks the
                same way and times the kernel, the plain version and
                ``F.conv2d``; the bound is the operations' at dense bf16
                peak.
Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  The kernels build in parallel, one
``nvcc`` per source.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dmfusion_torch.config import load_config, resolve_device
from dmfusion_torch.data.patches import gather_dual
from dmfusion_torch.data.scene import split_labels, synthetic_scene
from dmfusion_torch.export import load_artifact, save_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.models import build_model
from dmfusion_torch.models import dense_fusion
from dmfusion_torch.models.common import init_params
from dmfusion_torch.ops import gather as gather_ops
from dmfusion_torch.ops import conv3x3 as conv_ops
from dmfusion_torch.ops import pool as pool_ops
from dmfusion_torch.ops import strip_gather as strip_ops
from dmfusion_torch.ops._build import load_library
from dmfusion_torch.ops.metrics import aa_oa, confusion_matrix, render_class_map
from dmfusion_torch.tools import (BF16_FLOP_PER_S, HBM_BYTES_PER_S, card_line,
                                  conv_kernel_probe, strip_gather_bench,
                                  time_in_turns)
from dmfusion_torch.train.steps import DensePrograms

BUCKET = 4096
REQUESTS = 32
WARMUP = 3
# bf16 card logits vs f32 CPU logits: on the CPU, bf16 gmfnet at width 64
# lands 0.009-0.011 (max abs over 64 anchors) from its f32 logits, for
# dmfusion and for this port alike; a skipped or wrong layer moves them by
# the logits' own scale (about 1).
BF16_ATOL = 0.04
CFG = {"data_city": "image6", "patch_size": 16, "seed": 3407,
       "model_width": 64, "device": "cuda",
       "precision": {"compute_dtype": "bfloat16", "scene_dtype": "float32"}}
# The dense flagship: image6, width 32 (128 trunk channels), patch 16.
DENSE_CFG = {**CFG, "model_name": "dense_fusion", "model_width": 32}
DENSE_WARMUP, DENSE_MAPS, DENSE_BANDS = 2, 10, 4
# bf16 card logits vs f32 CPU logits of the dense model on a 96x96 crop:
# on the CPU the port's bf16 lands 0.00046-0.00059 (max abs over the
# 81x81x12 logits of four crops) from its f32 logits, at a logit scale of
# 0.024-0.029 for these seeded weights; a skipped or wrong layer moves
# them by that scale.
DENSE_BF16_ATOL = 0.002
# The strip bench's workload: 98,304 raster anchors in strips of 128.
STRIP_ANCHORS, STRIP = 98_304, 128
# The conv's checks off the probe's shape: odd shapes, then shapes on and
# off the kernel's 8 x 32 output tile.
CONV_SHAPES = ((37, 45), (5, 70), (1, 1), (9, 33), (8, 32), (7, 31),
               (1, 100), (100, 1))
# One entry per CUDA source of the driven paths.
KERNELS = {
    "gather_windows": {
        "route": "cuda", "source": "dmfusion_torch/csrc/gather_windows.cu",
        "replaces": "dmfusion/ops/pallas_gather.py:90",
        "counter": gather_ops.gather_windows_cuda,
        "unit": f"one dual bucket: MS + PAN launch, B={BUCKET}, f32 scene"},
    "phase_pool": {
        "route": "cuda", "source": "dmfusion_torch/csrc/phase_pool.cu",
        "replaces": "dmfusion/ops/pallas_pool.py:124",
        "counter": pool_ops.phase_pool_cuda,
        "unit": "one image6 w32 map pool: (1008, 1058, 128) -> "
                "(1001, 1051, 128) bf16, patch 16"},
    "strip_gather": {
        "route": "cuda", "source": "dmfusion_torch/csrc/strip_gather.cu",
        "replaces": "dmfusion/ops/pallas_strip_gather.py:80",
        "counter": strip_ops.gather_strips_cuda,
        "unit": f"one dual strip call: MS + PAN launch, {STRIP_ANCHORS} "
                f"image6 raster anchors in strips of {STRIP}, f32 scene"},
    "conv3x3": {
        "route": "cuda", "source": "dmfusion_torch/csrc/conv3x3.cu",
        "replaces": "tools/conv_kernel_probe.py:133",
        "counter": conv_ops.conv3x3_cuda,
        "unit": "one 3x3 128->128 SAME conv pass, (1008, 1058, 128) bf16"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card only")
    card = card_line()
    device = resolve_device(load_config(overrides=CFG))
    log(f"device: {torch.cuda.get_device_name(device)} | nvidia-smi: {card} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    return device, card


def phase_build() -> None:
    """One nvcc per source, all started together."""
    def build(name):
        t0 = time.perf_counter()
        load_library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        secs = dict(zip(KERNELS, ex.map(build, KERNELS)))
    log(f"build: {json.dumps(secs)}, {time.perf_counter() - t0:.2f} s in all")


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernels(scene, device) -> dict:
    """gather_windows vs gather_windows_ref at image6 shapes."""
    ps, w = scene.patch, scene.width
    h, c = scene.height, int(scene.ms.shape[-1])
    ms2d = scene.ms.reshape(scene.ms.shape[0], -1)
    # image6 at patch 16: MS view (2016, 8464), PAN view (8067, 8467).
    check(tuple(ms2d.shape) == (h + ps - 1, (w + ps - 1) * c),
          f"MS view {tuple(ms2d.shape)}")
    check(tuple(scene.pan.shape) == (4 * h + 4 * ps - 1, 4 * w + 4 * ps - 1),
          f"PAN view {tuple(scene.pan.shape)}")
    n = scene.num_pixels
    rng = np.random.default_rng(0)
    worst = 0.0

    def dual_case(ms, pan, ids_np, tag):
        nonlocal worst
        ids = torch.from_numpy(ids_np).to(device)
        got = gather_ops.gather_dual_fast(ms, pan, ids, w, ps)
        want = gather_dual(ms, pan, ids, w, ps)
        for g, r in zip(got, want):
            check(g.dtype == r.dtype and g.shape == r.shape, f"{tag}: shape")
            err = _max_err(g, r)
            worst = max(worst, err)
            check(torch.equal(g, r), f"{tag}: kernel != plain (max {err})")
        log(f"kernels: gather_dual {tag}: bit-equal "
            f"ms {tuple(got[0].shape)} pan {tuple(got[1].shape)}")

    ids = rng.integers(0, n, BUCKET).astype(np.int32)
    ids[0], ids[-1] = 0, n - 1
    dual_case(scene.ms, scene.pan, ids, f"f32 B={BUCKET}")
    dual_case(scene.ms, scene.pan, ids[:BUCKET - 3], f"f32 B={BUCKET - 3}")
    ms16, pan16 = scene.ms.bfloat16(), scene.pan.bfloat16()
    dual_case(ms16, pan16, ids, f"bf16 B={BUCKET}")
    del ms16, pan16

    for view, patch, chans in ((ms2d, ps, c), (scene.pan, 4 * ps, 1)):
        hi_r, hi_c = view.shape[0] + 5, view.shape[1] // chans + 5
        xs = torch.tensor([-1, -hi_r, 0, hi_r, 10**9, 3, -7], dtype=torch.int32,
                          device=device)
        ys = torch.tensor([0, 5, -hi_c, -1, 10**9, hi_c, -3], dtype=torch.int32,
                          device=device)
        got = gather_ops.gather_windows_cuda(view, xs, ys, patch, chans)
        want = gather_ops.gather_windows_ref(view, xs, ys, patch, chans)
        check(torch.equal(got, want), f"clamped anchors, patch {patch}")
    log("kernels: clamped and negative starts: bit-equal")

    # Timing: one dual bucket (the MS and the PAN launch), f32 scene; eight
    # anchor sets in turn so consecutive calls do not reuse L2 lines.  The
    # kernel and the indexing call get their anchors precomputed (int32
    # starts, int64 index grids), so each times its copy alone; the plain
    # version is timed whole, from the flat ids.
    sets = [torch.from_numpy(rng.integers(0, n, BUCKET).astype(np.int32)
                             ).to(device) for _ in range(8)]
    pan2d = scene.pan

    def views(ids):
        x, y = ids // w, ids % w
        return ((ms2d, ps, c, x, y), (pan2d, 4 * ps, 1, 4 * x, 4 * y))

    starts = [[(v, p, ch, xx.int().contiguous(), yy.int().contiguous())
               for v, p, ch, xx, yy in views(ids)] for ids in sets]
    grids = [[(v, (xx.long()[:, None] + torch.arange(p, device=device)
                   )[:, :, None],
               (yy.long()[:, None] * ch + torch.arange(p * ch, device=device)
                )[:, None, :])
              for v, p, ch, xx, yy in views(ids)] for ids in sets]
    runs = {
        "plain": lambda i: gather_dual(scene.ms, scene.pan, sets[i % 8], w, ps),
        "kernel": lambda i: [gather_ops.gather_windows_cuda(v, xx, yy, p, ch)
                             for v, p, ch, xx, yy in starts[i % 8]],
        "library": lambda i: [v[r, k] for v, r, k in grids[i % 8]],
    }
    med, times = time_in_turns(runs, iters=50)
    itemsize = scene.ms.element_size()
    moved = (2 * BUCKET * (ps * ps * c + (4 * ps) ** 2) * itemsize
             + 4 * BUCKET)  # windows read + written, anchor ids read
    bound = moved / HBM_BYTES_PER_S * 1e3
    log(f"kernels: gather_dual B={BUCKET} f32 ms median of 6: kernel "
        f"{med['kernel']:.4f} plain {med['plain']:.4f} library "
        f"{med['library']:.4f} bound {bound:.4f} ({moved / 1e6:.1f} MB); "
        f"all: {json.dumps(times)}")
    return {"gather_windows": {"max_abs_err": worst, "ms": med["kernel"],
                               "plain_ms": med["plain"],
                               "library_ms": med["library"],
                               "bound_ms": bound, "bound_by": "bytes"}}


def phase_serving(scene, device) -> dict:
    cfg = load_config(overrides=CFG)
    model = init_params(build_model(cfg),
                        torch.Generator().manual_seed(cfg["seed"]))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/gmfnet_image6.zip"
        save_artifact(path, cfg, model)
        clf = load_artifact(path, device)
    pred = ScenePredictor(clf, scene, bucket=BUCKET)
    labeled, _ = split_labels(scene.label)
    rng = np.random.default_rng(cfg["seed"])
    picked = rng.choice(labeled, (WARMUP + REQUESTS) * BUCKET, replace=False)
    chunks = picked.reshape(-1, BUCKET).astype(np.int32)
    for c in chunks[:WARMUP]:
        pred.predict_ids(c)
    served = chunks[WARMUP:]
    all_ids = served.reshape(-1)

    # flax's GroupNorm(dtype=bf16) returns bf16; autocast's group_norm runs
    # in f32, so the port's norm casts back and what follows stays bf16.
    norm_dtypes = set()
    hooks = [m.register_forward_hook(
        lambda _m, _in, out: norm_dtypes.add(out.dtype))
        for m in clf.model.modules() if isinstance(m, torch.nn.GroupNorm)]
    pred.predict_ids(chunks[0][:8])
    for h in hooks:
        h.remove()
    check(norm_dtypes == {torch.bfloat16}, f"norm outputs {norm_dtypes}")

    for spec in KERNELS.values():
        spec["counter"].launches = 0
    torch.cuda.synchronize()
    request_ms, preds = [], []
    for c in served:
        t0 = time.perf_counter()
        preds.append(pred.predict_ids(c))  # returns host labels: synchronized
        request_ms.append((time.perf_counter() - t0) * 1e3)
    metrics = pred.evaluate(all_ids)
    cmap = pred.class_map(all_ids)
    launches = {name: spec["counter"].launches for name, spec in KERNELS.items()}
    buckets = 3 * REQUESTS  # the requests, evaluate(), class_map()
    check(launches["gather_windows"] == 2 * buckets,
          f"gather_windows launches {launches['gather_windows']} != "
          f"2 x {buckets} buckets")

    preds = np.concatenate(preds)
    targets = scene.label.reshape(-1)[all_ids].astype(np.int32)
    conf = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets),
                            cfg["Categories_Number"]).numpy()
    check(np.array_equal(conf, metrics["confusion"]),
          "evaluate() differs from the served requests")
    x, y = scene.ids_to_xy(all_ids)
    check(np.array_equal(cmap[x, y], preds), "class_map differs from requests")
    img = render_class_map(torch.from_numpy(cmap), torch.tensor(
        cfg["DATA_DICT"]["image6"]["color"], dtype=torch.uint8))
    check(tuple(img.shape) == (scene.height, scene.width, 3), "class map shape")
    aa, oa, kap, _ = aa_oa(conf)

    # The same requests with the plain gather on the card.
    for c, p in zip(served, preds.reshape(REQUESTS, BUCKET)):
        ids = torch.from_numpy(c).to(device)
        ms_b, pan_b = gather_dual(scene.ms, scene.pan, ids, scene.width,
                                  scene.patch)
        plain = clf.predict(ms_b.float(), pan_b.float()).cpu().numpy()
        check(np.array_equal(plain, p), "kernel-gather and plain-gather "
              "predictions differ")

    # Where the time goes: a traced window of a few requests.
    from torch.profiler import ProfilerActivity, profile
    traced = served[:4]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in traced:
            pred.predict_ids(c)
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    gather_us = sum(e.self_device_time_total for e in on_device
                    if "gather_windows_kernel" in e.key)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:12]
    log("profile: " + json.dumps({
        "requests": len(traced), "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "gather_kernel_ms": gather_us / 1e3,
        "top_kernels_ms_calls": [[e.key[:90], e.self_device_time_total / 1e3,
                                  e.count] for e in top]}))

    # The served bf16 model and f32 on the card (TF32 off), each against
    # the same weights in f32 on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = load_config(overrides={**CFG, "precision": {
        "compute_dtype": "float32", "scene_dtype": "float32"}})
    state = clf.model.state_dict()
    card32 = build_model(cfg32).to(device, memory_format=torch.channels_last)
    card32.load_state_dict(state)
    cpu32 = build_model(cfg32)
    cpu32.load_state_dict({k: v.cpu() for k, v in state.items()})
    ids = torch.from_numpy(served[0][:64]).to(device)
    ms_b, pan_b = gather_ops.gather_dual_fast(scene.ms, scene.pan, ids,
                                              scene.width, scene.patch)
    with torch.inference_mode():
        on_card = card32.eval()(ms_b, pan_b).cpu()
        on_cpu = cpu32.eval()(ms_b.cpu(), pan_b.cpu())
        served16 = clf.logits(ms_b, pan_b).cpu()
    for t in (on_card, served16):
        check(bool(torch.isfinite(t).all()) and t.dtype == torch.float32
              and t.shape == on_cpu.shape, "served logits: dtype, shape or "
              "non-finite values")
    err32 = float((on_card - on_cpu).abs().max())
    check(err32 <= 1e-3, f"f32 card vs CPU logits differ by {err32}")
    err16 = float((served16 - on_cpu).abs().max())
    check(err16 <= BF16_ATOL, f"bf16 card vs f32 CPU logits differ by "
          f"{err16} > {BF16_ATOL}")
    agree16 = float((served16.argmax(-1) == on_cpu.argmax(-1)).float().mean())

    # The window's rate: every anchor served over the sum of request times.
    result = {"requests": REQUESTS, "bucket": BUCKET,
              "anchors_per_s": REQUESTS * BUCKET / sum(request_ms) * 1e3,
              "request_ms_median": statistics.median(request_ms),
              "request_ms_max": max(request_ms), "oa": oa, "aa": aa,
              "kappa": kap, "f32_card_vs_cpu_max_abs": err32,
              "bf16_card_vs_f32_cpu_max_abs": err16,
              "bf16_card_vs_f32_cpu_argmax_agree": agree16,
              "logit_scale": float(on_cpu.abs().max()),
              "launches": launches, "request_ms": request_ms}
    log(f"serving: {json.dumps(result)}")
    return launches


def _pool_out(hm: int, wm: int, patch: int) -> tuple[int, int]:
    return -(-(hm - patch + 1) // 2), -(-(wm - patch + 1) // 2)


def phase_pool(scene, device) -> dict:
    """phase_pool_cuda vs phase_pool_ref: bit-equal at the image6 w32
    shape (bf16 and f32), an odd-output, a wide, a large-patch and an
    unaligned-pixel geometry; timings."""
    hm, wm = int(scene.ms.shape[0]), int(scene.ms.shape[1])  # 2016 x 2116
    ps = scene.patch
    gen = torch.Generator(device=device).manual_seed(11)

    def feats(h2, w2, c4, dtype):
        return torch.randn((h2, w2, c4), generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    cases = [("image6 w32 bf16", -(-hm // 2), -(-wm // 2), 128, ps,
              torch.bfloat16, _pool_out(hm, wm, ps)),
             ("image6 w32 f32", -(-hm // 2), -(-wm // 2), 128, ps,
              torch.float32, _pool_out(hm, wm, ps)),
             ("odd 37x45 4C=64 p8 bf16", 37, 45, 64, 8, torch.bfloat16,
              _pool_out(73, 89, 8)),
             ("wide 4C=256 p32 f32", 60, 84, 256, 32, torch.float32,
              _pool_out(119, 167, 32)),
             ("large ph 4C=64 p34 f32 (shared body)", 45, 50, 64, 34,
              torch.float32, _pool_out(89, 99, 34)),
             ("unaligned 4C=12 p16 bf16 (24-byte pixels)", 100, 150, 12, 16,
              torch.bfloat16, _pool_out(199, 299, 16))]
    worst = 0.0
    for tag, h2, w2, c4, patch, dtype, (ni, nj) in cases:
        f = feats(h2, w2, c4, dtype)
        got = pool_ops.phase_pool_cuda(f, patch, ni, nj)
        want = pool_ops.phase_pool_ref(f, patch, ni, nj)
        torch.cuda.synchronize()
        worst = max(worst, _max_err(got, want))
        check(got.shape == want.shape == (ni, nj, c4) and got.dtype == dtype,
              f"phase_pool {tag}: shape or dtype")
        check(torch.equal(got, want), f"phase_pool {tag}: kernel != plain "
              f"(max {_max_err(got, want)})")
        log(f"kernels: phase_pool {tag}: bit-equal {tuple(f.shape)} -> "
            f"{tuple(got.shape)}")

    # Timing at the main path's shape, bf16: kernel, plain version, and one
    # avg_pool2d over the full-resolution (1, C, 2*H2, 2*W2) map (same
    # window means; no s2d packing and another rounding).
    h2, w2 = -(-hm // 2), -(-wm // 2)
    ni, nj = _pool_out(hm, wm, ps)
    f = feats(h2, w2, 128, torch.bfloat16)
    full = dense_fusion.depth_to_space(f, 2).permute(2, 0, 1)[None]
    full = full.contiguous()
    runs = {
        "plain": lambda i: pool_ops.phase_pool_ref(f, ps, ni, nj),
        "kernel": lambda i: pool_ops.phase_pool_cuda(f, ps, ni, nj),
        "library": lambda i: torch.nn.functional.avg_pool2d(full, ps, 1),
    }
    med, times = time_in_turns(runs, iters=10)
    moved = (h2 * w2 + ni * nj) * 128 * f.element_size()
    bound = moved / HBM_BYTES_PER_S * 1e3
    plan = pool_ops.launch_plan(
        h2, w2, 128, ps, ni, nj, f.element_size(),
        sms=torch.cuda.get_device_properties(device).multi_processor_count)
    log(f"kernels: phase_pool image6 w32 bf16 plan: {plan}")
    log(f"kernels: phase_pool image6 w32 bf16 ms median of 6: kernel "
        f"{med['kernel']:.4f} plain {med['plain']:.4f} library "
        f"{med['library']:.4f} bound {bound:.4f} ({moved / 1e6:.1f} MB); "
        f"all: {json.dumps(times)}")
    return {"max_abs_err": worst, "ms": med["kernel"], "plain_ms": med["plain"],
            "library_ms": med["library"], "bound_ms": bound,
            "bound_by": "bytes"}


def phase_dense(scene, device) -> dict:
    """Serve the image6 dense class map from an artifact; returns the
    launch counts of the timed maps."""
    cfg = load_config(overrides=DENSE_CFG)
    model = init_params(build_model(cfg),
                        torch.Generator().manual_seed(cfg["seed"]))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/dense_image6.zip"
        save_artifact(path, cfg, model)
        clf = load_artifact(path, device)
    check(clf.is_map and clf.manifest["dense_bands"] == 0,
          "dense artifact: not a whole-scene map artifact")
    for _ in range(DENSE_WARMUP):
        ScenePredictor(clf, scene).class_map()

    for spec in KERNELS.values():
        spec["counter"].launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    map_ms = []
    for _ in range(DENSE_MAPS):
        pred = ScenePredictor(clf, scene)  # a fresh cache: renders anew
        t0 = time.perf_counter()
        cmap = pred.class_map()  # host labels: synchronized
        map_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: spec["counter"].launches
                for name, spec in KERNELS.items()}
    check(launches["phase_pool"] == DENSE_MAPS,
          f"phase_pool launches {launches['phase_pool']} != {DENSE_MAPS} "
          f"maps")
    ncls = int(cfg["Categories_Number"])
    check(cmap.shape == (scene.height, scene.width) and cmap.min() >= 0
          and cmap.max() < ncls, "dense class map: shape or class range")
    metrics = pred.evaluate()
    check(metrics["pixels"] == int(np.count_nonzero(scene.label))
          and int(metrics["confusion"].sum()) == metrics["pixels"],
          "dense evaluate(): pixel count")

    # The same map with the plain pool on the card.
    dense_fusion.phase_pool = pool_ops.phase_pool_ref
    try:
        plain = ScenePredictor(clf, scene).class_map()
    finally:
        dense_fusion.phase_pool = pool_ops.phase_pool
    check(np.array_equal(plain, cmap), "kernel-pool and plain-pool maps "
          f"differ at {int((plain != cmap).sum())} pixels")

    # Four row bands: one pool launch per band.
    prog = DensePrograms(clf.model, scene.patch)
    before = pool_ops.phase_pool_cuda.launches
    banded = prog.class_map_streamed(scene.ms, scene.pan, DENSE_BANDS)
    band_launches = pool_ops.phase_pool_cuda.launches - before
    banded = banded.cpu().numpy()
    check(band_launches == DENSE_BANDS, f"streamed map: {band_launches} "
          f"pool launches for {DENSE_BANDS} bands")
    band_agree = float((banded == cmap).mean())
    check(band_agree >= 0.999, f"streamed map agrees {band_agree} < 0.999")

    # Where the time goes: a profile of two maps.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            ScenePredictor(clf, scene).class_map()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    pool_us = sum(e.self_device_time_total for e in on_device
                  if "phase_pool_kernel" in e.key)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:14]
    log("profile dense: " + json.dumps({
        "maps": 2, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / wall_us, "pool_kernel_ms": pool_us / 1e3,
        "pool_share_of_busy": pool_us / busy_us,
        "top_kernels_ms_calls": [[e.key[:90], e.self_device_time_total / 1e3,
                                  e.count] for e in top]}))

    # Precision on a 96x96 MS crop and its PAN: the served bf16 model and
    # f32 on the card (TF32 off), against f32 on the CPU, same weights.
    r0 = c0 = min(1000, scene.height - 96) // 2 * 2
    ms = scene.ms[r0:r0 + 96, c0:c0 + 96]
    pan = scene.pan[4 * r0:4 * (r0 + 96), 4 * c0:4 * (c0 + 96)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = load_config(overrides={**DENSE_CFG, "precision": {
        "compute_dtype": "float32", "scene_dtype": "float32"}})
    state = clf.model.state_dict()
    card32 = build_model(cfg32).to(device)
    card32.load_state_dict(state)
    cpu32 = build_model(cfg32)
    cpu32.load_state_dict({k: v.cpu() for k, v in state.items()})
    with torch.inference_mode():
        on_card = card32.eval()(ms, pan, scene.patch).cpu()
        on_cpu = cpu32.eval()(ms.cpu(), pan.cpu(), scene.patch)
        served16 = clf.logits(ms, pan).cpu()
    for t in (on_card, served16):
        check(bool(torch.isfinite(t).all()) and t.dtype == torch.float32
              and t.shape == on_cpu.shape
              == (97 - scene.patch, 97 - scene.patch, ncls),
              "dense logits: dtype, shape or non-finite values")
    err32 = float((on_card - on_cpu).abs().max())
    check(err32 <= 1e-3, f"dense f32 card vs CPU logits differ by {err32}")
    err16 = float((served16 - on_cpu).abs().max())
    check(err16 <= DENSE_BF16_ATOL, f"dense bf16 card vs f32 CPU logits "
          f"differ by {err16} > {DENSE_BF16_ATOL}")
    agree16 = float((served16.argmax(-1) == on_cpu.argmax(-1)).float().mean())

    pixels = scene.height * scene.width
    med = statistics.median(map_ms)
    result = {"maps": DENSE_MAPS, "map_ms_median": med,
              "map_ms_max": max(map_ms), "pixels": pixels,
              "pixels_per_s": pixels / med * 1e3,
              "oa": metrics["oa"], "aa": metrics["aa"],
              "kappa": metrics["kappa"], "launches": launches,
              "bands": DENSE_BANDS, "band_launches": band_launches,
              "band_vs_whole_agree": band_agree,
              "f32_card_vs_cpu_max_abs": err32,
              "bf16_card_vs_f32_cpu_max_abs": err16,
              "bf16_card_vs_f32_cpu_argmax_agree": agree16,
              "logit_scale": float(on_cpu.abs().max()),
              "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
              "map_ms": map_ms}
    log(f"dense: {json.dumps(result)}")
    return launches


def phase_strip(scene, device) -> tuple[int, dict]:
    """B3: bit-equality with the plain version, the strip bench on the
    card, timings; returns the bench's launches and the kernel's row."""
    ps, w = scene.patch, scene.width
    c = int(scene.ms.shape[-1])
    xs_np, y0s_np = strip_gather_bench.strip_grid(scene.height, w, ps,
                                                  STRIP_ANCHORS, STRIP)
    xs = torch.from_numpy(xs_np).to(device)
    y0s = torch.from_numpy(y0s_np).to(device)
    # Edge strips (MS starts; PAN at 4x): past the bottom, past the right
    # edge, wholly below the view, and one at the origin; odd columns.
    hv, wv = int(scene.ms.shape[0]), int(scene.ms.shape[1])
    ex = torch.tensor([hv - 5, 3, hv + 2, 0], dtype=torch.int32,
                      device=device)
    ey = torch.tensor([wv - 61, wv - 7, 5, 1], dtype=torch.int32,
                      device=device)
    ms16, pan16 = scene.ms.bfloat16(), scene.pan.bfloat16()
    cases = [("f32 bench", scene.ms, scene.pan, xs, y0s),
             ("bf16 bench", ms16, pan16, xs, y0s),
             ("f32 edge", scene.ms, scene.pan, ex, ey),
             ("bf16 edge", ms16, pan16, ex, ey)]
    counter = strip_ops.gather_strips_cuda
    worst = 0.0
    for tag, ms, pan, sx, sy in cases:
        before = counter.launches
        got = strip_ops.gather_dual_strips(ms, pan, sx, sy, w, ps, STRIP)
        check(counter.launches == before + 2,
              f"strip {tag}: {counter.launches - before} launches, not 2")
        want = strip_ops.gather_dual_strips_ref(ms, pan, sx, sy, w, ps, STRIP)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            worst = max(worst, _max_err(g, r))
            check(g.dtype == ms.dtype and g.shape == r.shape
                  and torch.equal(g, r), f"strip {tag}: kernel != plain")
        if "edge" in tag:
            check(not got[0][2 * STRIP:3 * STRIP].any()
                  and not got[1][2 * STRIP:3 * STRIP].any(),
                  "strip below the view: windows not all zero")
        log(f"kernels: strip_gather {tag}: bit-equal, {sx.shape[0]} strips "
            f"-> ms {tuple(got[0].shape)} pan {tuple(got[1].shape)}")
        del got, want
    del ms16, pan16

    # The main path: the strip bench on the card.
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    torch.cuda.synchronize()
    bench = strip_gather_bench.run(device, STRIP_ANCHORS, STRIP, ps)
    launches = counter.launches
    check(launches == 2 * bench["strip_calls"],
          f"strip bench: {launches} launches for {bench['strip_calls']} "
          f"dual strip calls")
    log(f"strip bench: {json.dumps(bench)}")

    # Timing: the kernel on precomputed int32 starts (its wrapper reads
    # them back once per launch for the negative-start check), the plain
    # version whole, and one indexing call per view on precomputed grids.
    views = ((scene.ms.reshape(hv, -1), xs, y0s, ps, wv, 1, c),
             (scene.pan, 4 * xs, 4 * y0s, 4 * ps, scene.pan.shape[1], 4, 1))
    grids = [strip_ops.strip_grids(v, sx, sy, p, ch, STRIP, st)
             for v, sx, sy, p, _, st, ch in views]
    runs = {
        "plain": lambda i: strip_ops.gather_dual_strips_ref(
            scene.ms, scene.pan, xs, y0s, w, ps, STRIP),
        "kernel": lambda i: [strip_ops.gather_strips_cuda(v, sx, sy, p, vw,
                                                          STRIP, st)
                             for v, sx, sy, p, vw, st, _ in views],
        "library": lambda i: [pv[r, k] for pv, r, k in grids],
    }
    med, times = time_in_turns(runs, iters=10)
    moved = strip_gather_bench.moved_bytes(scene.ms, scene.pan, xs, y0s, ps,
                                           STRIP)
    bound = moved / HBM_BYTES_PER_S * 1e3
    log(f"kernels: strip_gather {STRIP_ANCHORS} anchors f32 ms median of 6: "
        f"kernel {med['kernel']:.4f} plain {med['plain']:.4f} library "
        f"{med['library']:.4f} bound {bound:.4f} ({moved / 1e6:.1f} MB); "
        f"all: {json.dumps(times)}")
    return launches, {"max_abs_err": worst, "ms": med["kernel"],
                      "plain_ms": med["plain"], "library_ms": med["library"],
                      "bound_ms": bound, "bound_by": "bytes"}


def phase_conv(device) -> tuple[int, dict]:
    """B4: its SASS; one ulp of the plain version and of cuDNN at small
    shapes, the closed form of the constant case; then the conv probe at
    the trunk's shape; returns the probe's launches and the kernel's
    row."""
    counter = conv_ops.conv3x3_cuda
    sass = conv_kernel_probe.sass_report()
    log(f"kernels: conv3x3 build: {json.dumps(sass)}")
    ops = sass["sass"]
    check(ops["HGMMA"] > 0 and ops["UBLKCP"] > 0 and ops["HMMA"] == 0,
          f"conv3x3 SASS: {ops}")
    cases = [(h, w, *conv_kernel_probe.inputs(h, w, device, seed=h), None)
             for h, w in CONV_SHAPES]
    cases += [(h, w, *conv_kernel_probe.constant_case(h, w, device))
              for h, w in ((9, 33), (1, 100))]
    for h, w, x, wgt, exact in cases:
        tag = f"conv ({h}, {w}){' constant' if exact is not None else ''}"
        before = counter.launches
        got = conv_ops.conv3x3_cuda(x, wgt)
        check(counter.launches == before + 1, f"{tag}: launches")
        if exact is not None:
            check(torch.equal(got, exact), f"{tag}: not the closed form")
        abs_sum = conv_ops.conv3x3_f32(x.abs(), wgt.abs())
        for name, want in (("plain", conv_ops.conv3x3_ref(x, wgt)),
                           ("cuDNN", conv_ops.conv3x3_library(x, wgt))):
            rep = conv_ops.ulp_report(got, want, abs_sum)
            check(rep["ok"], f"{tag} vs {name}: {rep}")
            log(f"kernels: {tag} vs {name}: {rep}")

    # The main path: the conv probe on the card.
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    torch.cuda.synchronize()
    probe = conv_kernel_probe.run(device)
    launches = counter.launches
    check(launches == probe["kernel_calls"],
          f"conv probe: {launches} launches for {probe['kernel_calls']} "
          f"passes")
    log(f"conv probe: {json.dumps(probe)}")
    by_ops = probe["flop"] / BF16_FLOP_PER_S * 1e3
    by_bytes = probe["bytes"] / HBM_BYTES_PER_S * 1e3
    return launches, {"max_abs_err": probe["vs_plain"]["max_abs"],
                      "ms": probe["ms"]["kernel"],
                      "plain_ms": probe["ms"]["plain"],
                      "library_ms": probe["ms"]["library"],
                      "bound_ms": max(by_ops, by_bytes),
                      "bound_by": "operations" if by_ops >= by_bytes
                      else "bytes"}


def main() -> None:
    device, card = phase_device()
    phase_build()
    t0 = time.perf_counter()
    scene = synthetic_scene(load_config(overrides=CFG), device=device)
    torch.cuda.synchronize()
    log(f"scene: {CFG['data_city']} synthetic, ms {tuple(scene.ms.shape)} pan "
        f"{tuple(scene.pan.shape)} {scene.ms.dtype}, "
        f"{time.perf_counter() - t0:.2f} s")
    timings = phase_kernels(scene, device)
    # Each path is driven with every count set to 0 just before it and read
    # just after; a kernel's launches are those of its own path.
    launches = {"gather_windows":
                phase_serving(scene, device)["gather_windows"]}
    timings["phase_pool"] = phase_pool(scene, device)
    launches["phase_pool"] = phase_dense(scene, device)["phase_pool"]
    launches["strip_gather"], timings["strip_gather"] = phase_strip(scene,
                                                                    device)
    del scene
    launches["conv3x3"], timings["conv3x3"] = phase_conv(device)
    rows = []
    for name, spec in KERNELS.items():
        t = timings[name]
        check(launches[name] > 0, f"{name} never launched on the main path")
        rows.append({"name": name, "route": spec["route"],
                     "source": spec["source"], "replaces": spec["replaces"],
                     "launches": launches[name], "ok": True,
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "unit": spec["unit"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
