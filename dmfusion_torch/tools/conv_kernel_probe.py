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
time.
"""

from __future__ import annotations

import argparse
import json
import math

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
