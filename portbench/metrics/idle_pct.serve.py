"""idle_pct.serve: share of the traced serving stretch with no kernel,
copy or set on the card (profiler trace)."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
