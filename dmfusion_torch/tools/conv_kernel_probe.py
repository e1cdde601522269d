"""The dense trunk's 3x3 128 -> 128 bf16 convolution: the port's kernel
(B4) against its plain version and cuDNN.

Port of ``tools/conv_kernel_probe.py``.  It seeds ``x ~ N(0, 1)`` of shape
``(h, w, 128)`` and HWIO weights ``~ N(0, 1) / sqrt(9 * 128)`` from a
``torch.Generator``, both rounded to bf16; holds the kernel to the plain
version and to one ``F.conv2d`` call (cuDNN on the card) as "equal or one
bf16 ulp apart" (``dmfusion_torch.ops.conv3x3.ulp_report``); and on the
card times the three with CUDA events, in turns.

    python -m dmfusion_torch.tools.conv_kernel_probe [--h 1008 --w 1058]
    python -m dmfusion_torch.tools.conv_kernel_probe --device cpu --h 20 --w 27

On the CPU it checks the plain version against ``F.conv2d`` and does not
time.  :func:`constant_case` gives inputs whose output is known in closed
form, and :func:`sass_report` what the built kernel compiled to.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
from pathlib import Path

import torch

from dmfusion_torch.config import resolve_device
from dmfusion_torch.ops.conv3x3 import (CHANNELS, conv3x3, conv3x3_f32,
                                        conv3x3_library, conv3x3_ref,
                                        ulp_report)
from dmfusion_torch.tools import card_line, time_in_turns

ROUNDS, WARMUP, ITERS = 3, 3, 10


def inputs(h: int, w: int, device: torch.device, seed: int = 0
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded bf16 ``x`` (h, w, 128) and HWIO weights (3, 3, 128, 128)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((h, w, CHANNELS), generator=gen, device=device)
    wgt = torch.randn((3, 3, CHANNELS, CHANNELS), generator=gen,
                      device=device) / math.sqrt(9 * CHANNELS)
    return x.bfloat16(), wgt.bfloat16()


def constant_case(h: int, w: int, device: str | torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x = 1`` and every weight ``bf16(1/1152)``: output (y, x) is
    ``n * 128 * w`` for the n taps of the pixel that lie in the image (9
    inside, 6 on an edge, 4 in a corner, fewer in a one-pixel-wide image).
    Every partial sum is a multiple of ``w`` below 2**11 times it, exact in
    f32 in any order, so the kernel must give this closed form bit for bit.
    Returns x, the weights and the closed form, bf16."""
    x = torch.ones((h, w, CHANNELS), dtype=torch.bfloat16, device=device)
    wgt = torch.full((3, 3, CHANNELS, CHANNELS), 1 / 1152,
                     dtype=torch.bfloat16, device=device)

    def taps(n):  # in-image neighbours of each index along one axis
        i = torch.arange(n, device=device)
        return (i + 1).clamp(max=n - 1) - (i - 1).clamp(min=0) + 1

    n = taps(h)[:, None] * taps(w)[None, :]
    want = (n.float() * (CHANNELS * wgt[0, 0, 0, 0].float())).bfloat16()
    return x, wgt, want[..., None].expand(h, w, CHANNELS)


def sass_report() -> dict:
    """What the built ``conv3x3`` library compiled to, from the card's
    toolkit: counts of the SASS instructions that show the design (HGMMA:
    wgmma; HMMA: mma.sync, which it must not use; UBLKCP: bulk copies;
    SYNCS: mbarrier operations) and ``cuobjdump -res-usage``'s registers,
    stack and local bytes a thread."""
    from dmfusion_torch.ops._build import _nvcc, library_path, load_library
    load_library("conv3x3")
    lib = str(library_path("conv3x3"))
    cuobjdump = str(Path(_nvcc()).with_name("cuobjdump"))

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    sass = dump("-sass")
    counts = {op: len(re.findall(rf"\b{op}[.\s]", sass))
              for op in ("HGMMA", "HMMA", "UBLKCP", "SYNCS")}
    use = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                    dump("-res-usage"))
    return {"sass": counts, "registers": int(use[1]), "stack": int(use[2]),
            "local": int(use[4])}


def run(device: str | torch.device = "cuda", h: int = 1008,
        w: int = 1058) -> dict:
    """Check the conv against its plain version and ``F.conv2d`` and, on
    the card, time the three.  Raises if a check fails, or without a card
    unless ``device`` is cpu."""
    device = resolve_device({"device": str(device)})
    x, wgt = inputs(h, w, device)
    abs_sum = conv3x3_f32(x.abs(), wgt.abs())
    got = conv3x3(x, wgt)
    checks = {"vs_plain": ulp_report(got, conv3x3_ref(x, wgt), abs_sum),
              "vs_library": ulp_report(got, conv3x3_library(x, wgt),
                                       abs_sum)}
    del got, abs_sum
    for name, rep in checks.items():
        if not rep["ok"]:
            raise RuntimeError(f"conv3x3 {name}: {rep}")
    flops = 2 * h * w * 9 * CHANNELS * CHANNELS
    result = {"device": str(device), "shape": [h, w, CHANNELS],
              "dtype": "bfloat16", **checks, "flop": flops,
              "bytes": (2 * h * w * CHANNELS + 9 * CHANNELS * CHANNELS)
              * x.element_size()}
    calls = 1
    if device.type == "cuda":
        runs = {"plain": lambda i: conv3x3_ref(x, wgt),
                "kernel": lambda i: conv3x3(x, wgt),
                "library": lambda i: conv3x3_library(x, wgt)}
        med, every = time_in_turns(runs, ITERS, ROUNDS, WARMUP)
        calls += 2 * ROUNDS * (WARMUP + ITERS)
        result.update({"gpu": torch.cuda.get_device_name(device), "ms": med,
                       "tflop_per_s": {k: flops / v / 1e9
                                       for k, v in med.items()},
                       "ms_all": every})
    result["kernel_calls"] = calls
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--h", type=int, default=1008)
    ap.add_argument("--w", type=int, default=1058)
    args = ap.parse_args(argv)
    result = run(args.device, args.h, args.w)
    print(json.dumps(result))
    if result["device"].startswith("cuda"):
        print(card_line())


if __name__ == "__main__":
    main()
