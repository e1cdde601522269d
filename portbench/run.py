"""Run one cell of the port's benchmark on the card.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its
limit.  The same numbers end standard error.  Without a CUDA card, or
with fewer cards than the cell asks for, it exits 2 and prints no result;
if the process holds JAX or the JAX package once the window has closed,
it exits 3 and prints no result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: Top-level modules that may not be in the process: JAX, its libraries
#: and the JAX package (compared by whole top-level name).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dmfusion")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def card_report() -> dict:
    """The card's name, power limit and clocks from ``nvidia-smi`` (printed
    on standard error, not in the result)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return {"nvidia_smi": out.stdout.strip().splitlines()[0]}
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"unavailable: {exc}"}


def _caches(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels under ``build/kernels/`` itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(root, "build", sub))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.getcwd()
    _caches(root)
    t_torch = time.perf_counter()
    import torch
    t_torch = time.perf_counter() - t_torch

    from portbench import harness
    from portbench.bench import Benchmark

    bench = Benchmark(root)
    chips = int(bench.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_report()
    print(f"[portbench] card {card['nvidia_smi']}", file=sys.stderr)

    run, checks = harness.run_cell(bench, args.workload, args.seed,
                                   args.seconds, bool(args.trace), device,
                                   PROCESS_START)
    metrics = harness.metrics(bench, run, bool(args.trace))
    correct, table = harness.judge(run, checks)
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] the process holds {bad}: JAX or the JAX package "
              f"was imported", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(device),
                         "count": chips,
                         "memory_peak_bytes": int(run.memory_peak_bytes)}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = table
    print(f"[portbench] {args.workload} seed {args.seed}: window "
          f"{run.window_s:.3f} s, {run.attempted} units, setup "
          f"{run.setup_s:.3f} s; card {card['nvidia_smi']}", file=sys.stderr)
    phases = {n: run.spans.total(n) for n, _, _ in run.spans.records
              if n.startswith("setup.")}
    print(f"[portbench] setup phases (s): {phases}; before them: "
          f"{run.setup_started - PROCESS_START:.3f} (import torch "
          f"{t_torch:.3f})", file=sys.stderr)
    for name, row in table.items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
