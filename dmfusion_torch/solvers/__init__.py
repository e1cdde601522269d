from dmfusion_torch.solvers.base import BaseSolver  # noqa: F401
from dmfusion_torch.solvers.main import Solver  # noqa: F401
from dmfusion_torch.solvers.twostage import TwoStageSolver  # noqa: F401


def build_solver(cfg):
    """Solver factory: ``cfg['solver']`` selects 'main' or the two-stage
    DQTL solver ('twostage', alias 'tostage' or 'dqtl')."""
    kind = str(cfg.get("solver", "main")).lower()
    if kind == "main":
        return Solver(cfg)
    if kind in ("twostage", "tostage", "dqtl"):
        return TwoStageSolver(cfg)
    raise ValueError(f"unknown solver {kind!r}")
