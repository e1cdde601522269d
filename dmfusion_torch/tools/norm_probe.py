"""gmfnet-w64-p16's 13 GroupNorms (B5) at a served bucket: the kernel
against its plain version, timed on the card.

    python -m dmfusion_torch.tools.norm_probe [--batch 4096] [--ptxas]
    python -m dmfusion_torch.tools.norm_probe --device cpu --batch 8

For each distinct norm of a gmfnet forward (channels-last bf16; the five
ResBlocks' second norms with their residual, ReLU after each) it seeds
``N(0.3, 2)`` activations, runs ``ops/norm.py::group_norm_act_cuda`` and
``group_norm_act_ref``, and reports the share of elements bit-equal, the
largest distance in bf16 ulps, and in ulps at the scale of the norm's own
terms (``ops/norm.py::ulp_report``: at most 2, and at least 99 %
bit-equal, or it raises); then times, with CUDA events in turns
(median of 6 windows), the kernel, the plain version and the library path
it replaces (``F.group_norm`` under autocast, cast back, the add and the
ReLU: a yardstick only) at each shape, beside the bytes bound (x, the
residual and the output once each at 3.35 TB/s), and sums them over the 13
launches of a request.  ``--ptxas`` builds ``csrc/group_norm_act.cu`` once
more with ``nvcc -Xptxas -v``.  On the CPU it runs the plain version at a
small batch and does not time.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from dmfusion_torch.config import resolve_device
from dmfusion_torch.ops import norm
from dmfusion_torch.tools import (HBM_BYTES_PER_S, card_line, ptxas_report,
                                  time_in_turns)

GROUPS = 8
# (C, H, W), with a residual, and how many a gmfnet-w64-p16 forward runs.
NORMS = [((32, 16, 16), False, 2), ((64, 16, 16), False, 3),
         ((128, 8, 8), False, 2), ((256, 4, 4), False, 1),
         ((64, 16, 16), True, 2), ((128, 8, 8), True, 2),
         ((256, 4, 4), True, 1)]
#: The unit ``chip_smoke.py`` reports: ms_res's second norm.
UNIT = ((64, 16, 16), True)
ROUNDS, WARMUP, ITERS = 3, 3, 20


def run(device: str | torch.device = "cuda", batch: int = 4096) -> dict:
    """Check each norm against the plain version and, on the card, time
    it.  Raises if a check fails, or without a card unless ``device`` is
    cpu."""
    device = resolve_device({"device": str(device)})
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"device": str(device), "batch": batch, "norms": []}
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (c, h, w), with_res, count in NORMS:
        def seeded():
            t = torch.randn((batch, c, h, w), generator=gen, device=device)
            return (t * 2 + 0.3).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
        x = seeded()
        res = seeded() if with_res else None
        wt = 1 + 0.5 * torch.randn(c, generator=gen, device=device)
        b = 0.2 * torch.randn(c, generator=gen, device=device)
        row = {"shape": [batch, c, h, w], "residual": with_res,
               "launches": count,
               "plan": norm.launch_plan(batch, c, h, w, GROUPS, 2, True,
                                        with_res).as_ints()}
        with torch.inference_mode():
            want = norm.group_norm_act_ref(x, GROUPS, wt, b, "relu", res)
            if device.type != "cuda":
                result["norms"].append(row)
                continue
            got = norm.group_norm_act_cuda(x, GROUPS, wt, b, "relu", res)
            torch.cuda.synchronize()
            row.update(norm.ulp_report(got, want, x, GROUPS, wt, b))
            if not row["ok"] or row["bit_equal_share"] < 0.99:
                raise RuntimeError(f"group_norm_act differs from the plain "
                                   f"version: {row}")
            del got, want

            def library(_):
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    y = F.group_norm(x, GROUPS, wt, b,
                                     norm.GROUPNORM_EPS).to(x.dtype)
                    return F.relu(y if res is None else y + res)
            runs = {"kernel": lambda _: norm.group_norm_act_cuda(
                        x, GROUPS, wt, b, "relu", res),
                    "plain": lambda _: norm.group_norm_act_ref(
                        x, GROUPS, wt, b, "relu", res),
                    "library": library}
            med, _ = time_in_turns(runs, ITERS, ROUNDS, WARMUP)
            moved = x.numel() * x.element_size() * (3 if with_res else 2)
            row.update(ms=med["kernel"], plain_ms=med["plain"],
                       library_ms=med["library"], moved_bytes=moved,
                       bound_ms=moved / HBM_BYTES_PER_S * 1e3)
            for k in sums:
                sums[k] += count * row[k]
        result["norms"].append(row)
        if ((c, h, w), with_res) == UNIT:
            result["unit"] = row
        del x, res
    if device.type == "cuda":
        result["request"] = sums
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    result = run(args.device, args.batch)
    if args.ptxas:
        result["ptxas"] = ptxas_report("group_norm_act")
    print(json.dumps(result))
    if result["device"].startswith("cuda"):
        print(card_line())


if __name__ == "__main__":
    main()
