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
    cfg = load_config(args.config, overrides=overrides, prepare=True)

    if cfg.get("debug", {}).get("nans"):
        import torch
        torch.autograd.set_detect_anomaly(True)

    from dmfusion_torch.solvers import build_solver
    solver = build_solver(cfg)
    solver.run()
    return solver


if __name__ == "__main__":
    main()
