from dmfusion_torch.solvers.base import BaseSolver  # noqa: F401
from dmfusion_torch.solvers.main import Solver  # noqa: F401


def build_solver(cfg):
    """Solver factory: ``cfg['solver']`` selects 'main' (or 'twostage',
    not ported yet)."""
    kind = str(cfg.get("solver", "main")).lower()
    if kind == "main":
        return Solver(cfg)
    if kind in ("twostage", "tostage", "dqtl"):
        raise NotImplementedError(
            "the two-stage DQTL solver is not ported to dmfusion_torch yet "
            "(ROADMAP A11)")
    raise ValueError(f"unknown solver {kind!r}")
