"""Command line: train, test and color a model with the port.

    python -m dmfusion_torch.cli [--config config.yml] [--solver main]
                                 [--model NAME] [--city CITY]
                                 [--set key=value ...]

Port of ``dmfusion/cli.py``: renders the config (the built-in schema, a
YAML file, then the ``--set`` overrides), allocates a result slot, builds
the solver and runs its repeat loop.  ``--config`` needs PyYAML; without
it, pass everything through ``--set``.  The run is on ``cuda:0`` unless
``--set device=cpu``, and raises without a card.  ``debug.nans`` turns on
autograd's anomaly detection.  ``main(argv)`` returns the solver.

Ranks on the mesh (``parallel/mesh.py``): the ``data`` axis, and with
``mesh.model=M`` the ``model`` axis (tensor parallelism, M ranks a data
index, ``parallel/partition.py``):

    torchrun --standalone --nproc-per-node N -m dmfusion_torch.cli \
        --set mesh.distributed=1 [mesh.model=M] ...

(or ``python -m torch.distributed.run``).  The process group comes up
before the solver exists, which allocates the run slot (under a mesh
rank 0 allocates it and the others receive it), and goes down at the
end, also on an error.  Each rank prints its backend and device when it
joins, and one ``[dmfusion] rank report {...}`` JSON line at the end: its
rank, device, backend, the mesh's axes (``mesh_data``, ``mesh_model``),
the solver, the window kernel's and the pool kernel's launches and the
phases' seconds (with ``--solver twostage`` also
stage 1's epochs and seconds, 0 when ``dqtl.pre_trained`` skips it; for the
dense arity the rank's band, ``dense_band``: ``out_start``, ``s0``,
``need`` and ``band`` rows, null when the scene runs whole on every
rank).
"""

from __future__ import annotations

import argparse
from typing import Any


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="python -m dmfusion_torch.cli")
    ap.add_argument("--config", default=None,
                    help="YAML config path (defaults to built-in schema)")
    ap.add_argument("--solver", default=None, choices=["main", "twostage"])
    ap.add_argument("--model", default=None, help="model_name override")
    ap.add_argument("--city", default=None, help="data_city override")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="dotted config overrides, e.g. schedule.lr=1e-4")
    args = ap.parse_args(argv)

    from dmfusion_torch.config import load_config, parse_overrides
    overrides: dict[str, Any] = parse_overrides(args.set)
    if args.solver:
        overrides["solver"] = args.solver
    if args.model:
        overrides["model_name"] = args.model
    if args.city:
        overrides["data_city"] = args.city
    cfg = load_config(args.config, overrides=overrides)

    if cfg.get("debug", {}).get("nans"):
        import torch
        torch.autograd.set_detect_anomaly(True)

    from dmfusion_torch import parallel
    owned = not parallel.is_distributed()
    ranks = parallel.maybe_initialize_distributed(cfg)
    try:
        from dmfusion_torch.solvers import build_solver
        solver = build_solver(cfg)
        solver.run()
        if ranks:
            _report(solver)
    finally:
        if ranks and owned:
            parallel.shutdown()
    return solver


def _report(solver) -> None:
    """One JSON line per rank: what it ran on and what it launched."""
    import json

    import torch

    from dmfusion_torch.ops.gather import gather_windows_cuda
    from dmfusion_torch.ops.pool import phase_pool_cuda
    from dmfusion_torch.train.steps import DensePrograms
    mesh = solver.mesh
    report = {
        "rank": torch.distributed.get_rank(),
        "world": torch.distributed.get_world_size(),
        "device": str(solver.device),
        "backend": str(torch.distributed.get_backend()),
        "mesh_data": mesh.data if mesh is not None else 1,
        "mesh_model": mesh.model if mesh is not None else 1,
        "solver": solver.cfg.get("solver", "main"),
        # B1: one launch a family call (every stream of a gathered batch).
        "gather_windows_launches": gather_windows_cuda.launches,
        "phase_pool_launches": phase_pool_cuda.launches,
        "train_s": solver.train_time, "test_s": solver.test_time,
        "color_s": getattr(solver, "color_time", 0.0)}
    stage1 = getattr(solver, "stage1_log", None)
    if stage1 is not None:
        report.update(stage1_epochs=len(stage1.get("epoch_s", [])),
                      stage1_s=stage1.get("stage1_s", 0.0))
    if isinstance(solver.programs, DensePrograms):
        report["dense_band"] = solver.programs.mesh_band(
            solver.scene.ms.shape[0])
    print("[dmfusion] rank report " + json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
