"""idle_pct.train: share of the traced training stretch with no kernel,
copy or set on the card (profiler trace)."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
