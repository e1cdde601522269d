"""Probe entry points, one kernel each, and the timing helpers they share
with ``chip_smoke.py``.

    python -m dmfusion_torch.tools.strip_gather_bench   # kernel B3
    python -m dmfusion_torch.tools.conv_kernel_probe    # kernel B4
    python -m dmfusion_torch.tools.pool_probe           # kernel B2
    python -m dmfusion_torch.tools.gather_probe         # kernel B1
    python -m dmfusion_torch.tools.norm_probe           # kernel B5
    python -m dmfusion_torch.tools.attn_probe           # kernel B6

Each runs on ``cuda:0`` unless given ``--device cpu`` (a small run of the
plain versions, untimed), and raises when no card is present.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import tempfile
from typing import Callable, Mapping

import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): device memory, and dense
# bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable[[int], object], iters: int = 50,
            warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(i)`` over ``iters`` calls,
    between two CUDA events, after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(runs: Mapping[str, Callable[[int], object]], iters: int,
                  rounds: int = 3, warmup: int = 3
                  ) -> tuple[dict[str, float], dict[str, list[float]]]:
    """Time each run with :func:`cuda_ms` in turns, the runs' order and its
    reverse ``rounds`` times each; returns the medians and every window."""
    times: dict[str, list[float]] = {k: [] for k in runs}
    for order in (tuple(runs), tuple(reversed(runs))) * rounds:
        for k in order:
            times[k].append(cuda_ms(runs[k], iters, warmup))
    return {k: statistics.median(v) for k, v in times.items()}, times


def ptxas_report(name: str) -> dict:
    """``nvcc -Xptxas -v`` over ``csrc/<name>.cu``: per kernel (mangled
    name), its registers, spill stores and loads (bytes) and stack bytes."""
    from dmfusion_torch.ops._build import CSRC, NVCC_FLAGS, _nvcc
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/lib.so",
             str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=900, check=True)
    report, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m[1]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            report.setdefault(kernel, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]),
                spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            report.setdefault(kernel, {})["registers"] = int(m[1])
    return report
