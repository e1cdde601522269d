"""Readings that the limits of a cell's check are set from, at the cell's
own size, on the card:

    python3 -m portbench.calibrate --workload NAME --seconds S \
        --seeds N [N ...] [--control-seeds N ...] [--fault-seeds N ...]

For each of ``--seeds``: a run of the program (set-up, a window of ``S``
seconds, the check), and its numbers: the lower readings.  For each of
``--control-seeds``: the same inputs given to the control, the reference
computed with float8 (e4m3) operands in the program's place, judged by the
same comparison: the upper readings.  For each of ``--fault-seeds``: a run
with each of the cell's faults (``portbench/faults.py``) planted in the
program.  One JSON line a reading on standard output.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import checks, faults, harness
from portbench.bench import Benchmark, entry
from portbench.reference.common import bf16, fp8


def control(run) -> dict[str, float]:
    """The check's numbers with the float8 reference as the program, and
    for label checks how many labels the program and the control each
    served other than the reference's argmax, of how many compared."""
    st, kind = run.state, run.traffic["entry"]
    drv = entry(kind)
    if kind == "train_epoch":
        ref = drv.reference_steps(run, st)
        low = drv.reference_steps(run, st, fp8)
        norm = drv.reference_steps(run, st, bf16, steps=1)
        return dict(checks.train_gaps(low, ref, norm),
                    worst_program=_worst(st.prog, ref),
                    worst_control=_worst(low, ref),
                    program_losses=st.prog["losses"], ref_losses=ref["losses"])
    gaps, logit, n, prog_off, low_off = [], [], 0, 0, 0
    for key, served, _ in st.kept.kept:
        ref = drv.reference_logits(run, st, key)
        low_logits = drv.reference_logits(run, st, key, fp8)
        low = low_logits.argmax(-1)
        gaps.append(checks.label_gap(ref, low))
        logit.append(checks.logit_gap(low_logits, ref))
        best = ref.argmax(-1)
        served = torch.from_numpy(served).to(best.device).long()
        n += best.numel()
        prog_off += int((served != best).sum())
        low_off += int((low != best).sum())
        del ref, low_logits
    return {"label_gap": max(gaps), "logit_gap": max(logit), "compared": n,
            "program_off": prog_off, "control_off": low_off}


def _worst(got: dict, ref: dict) -> dict:
    """The leaf each training number is read at, and its norms."""
    keep = checks.moving_leaves(ref["grad"])
    out = {}
    for key in ("grad", "delta"):
        gaps = checks.leaf_gaps(got[key], ref[key],
                                None if key == "grad" else keep)
        top = sorted(gaps, key=gaps.get, reverse=True)[:3]
        out[key] = [[k, gaps[k], got[key][k], ref[key][k]] for k in top]
    return out


def reading(bench, workload, seed, seconds, device, fault=None,
            with_control=False, over=None) -> dict:
    t0 = time.perf_counter()
    # Training's numbers are read in set-up: it needs no window.
    window = bench.traffic(bench.workload(workload)["traffic"])[
        "entry"] != "train_epoch"
    run = None
    if fault is None:
        run, nums = harness.run_cell(bench, workload, seed, seconds, False,
                                     device, t0, over, window)
    else:
        classes = int(bench.config(bench.workload(workload)["config"])
                      ["classes"])
        with faults.plant(fault, classes):
            run, nums = harness.run_cell(bench, workload, seed, seconds,
                                         False, device, t0, over, window)
    out = {"workload": workload, "seed": seed, "fault": fault,
           "program": nums, "attempted": run.attempted,
           "failed": run.failed, "seconds": time.perf_counter() - t0}
    if with_control:
        out["control"] = control(run)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs the card", file=sys.stderr)
        return 2
    bench = Benchmark(os.getcwd())
    device = torch.device("cuda", 0)
    kind = bench.traffic(bench.workload(args.workload)["traffic"])["entry"]
    for seed in args.seeds:
        print(json.dumps(reading(bench, args.workload, seed, args.seconds,
                                 device,
                                 with_control=seed in args.control_seeds)),
              flush=True)
    for seed in args.control_seeds:
        if seed not in args.seeds:
            print(json.dumps(reading(bench, args.workload, seed,
                                     args.seconds, device,
                                     with_control=True)), flush=True)
    for seed in args.fault_seeds:
        for fault in faults.BY_ENTRY[kind]:
            print(json.dumps(reading(
                bench, args.workload, seed, args.seconds, device, fault,
                with_control=seed in args.control_seeds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
