"""The dense map's phase window-pool (B2) at its served shape: the kernel
against its plain version, timed on the card.

    python -m dmfusion_torch.tools.pool_probe [--dtype bf16] [--ptxas]
    python -m dmfusion_torch.tools.pool_probe --device cpu --h2 40 --w2 50

It seeds ``N(0, 1)`` features of the image6 width-32 trunk,
``(1008, 1058, 128)``, pools them at patch 16 to ``(1001, 1051, 128)``
through ``ops/pool.py::phase_pool_cuda``, requires the result to equal
``phase_pool_ref`` bit for bit, and times the kernel with CUDA events
(median of 6 windows) beside its bytes bound.  ``--ptxas`` builds
``csrc/phase_pool.cu`` once more with ``nvcc -Xptxas -v`` and reports
each kernel's registers, spills and stack.
The timing uses only ``phase_pool_cuda(feats, patch, ni, nj)``, so the
script also times an older tree's kernel when copied into it.  On the
CPU it checks the plain version at a small size and does not time.
"""

from __future__ import annotations

import argparse
import json

import torch

from dmfusion_torch.config import resolve_device
from dmfusion_torch.ops import pool
from dmfusion_torch.tools import (HBM_BYTES_PER_S, card_line, ptxas_report,
                                  time_in_turns)

PATCH, C4 = 16, 128
ROUNDS, WARMUP, ITERS = 3, 3, 10
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def run(device: str | torch.device = "cuda", dtype: str = "bf16",
        h2: int = 1008, w2: int = 1058) -> dict:
    """Check the kernel against the plain version and, on the card, time
    it.  Raises if a check fails, or without a card unless ``device`` is
    cpu."""
    device = resolve_device({"device": str(device)})
    gen = torch.Generator(device=device).manual_seed(0)
    f = torch.randn((h2, w2, C4), generator=gen, device=device).to(
        DTYPES[dtype])
    ni, nj = h2 - PATCH // 2 + 1, w2 - PATCH // 2 + 1
    want = pool.phase_pool_ref(f, PATCH, ni, nj)
    result = {"device": str(device), "dtype": dtype,
              "features": [h2, w2, C4], "out": [ni, nj, C4], "patch": PATCH}
    if device.type != "cuda":
        result["plain_shape"] = list(want.shape)
        return result
    runs = {"kernel": lambda i: pool.phase_pool_cuda(f, PATCH, ni, nj)}
    got = runs["kernel"](0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("phase_pool kernel differs from the plain version")
    del want, got
    med, every = time_in_turns(runs, ITERS, ROUNDS, WARMUP)
    moved = (h2 * w2 + ni * nj) * C4 * f.element_size()
    bound = moved / HBM_BYTES_PER_S * 1e3
    result.update({
        "gpu": torch.cuda.get_device_name(device), "bit_equal": True,
        "ms": med, "bound_ms": bound, "bytes": moved,
        "bound_share": bound / med["kernel"], "ms_all": every})
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--h2", type=int, default=1008)
    ap.add_argument("--w2", type=int, default=1058)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    result = run(args.device, args.dtype, args.h2, args.w2)
    if args.ptxas:
        result["ptxas"] = ptxas_report("phase_pool")
    print(json.dumps(result))
    if result["device"].startswith("cuda"):
        print(card_line())


if __name__ == "__main__":
    main()
