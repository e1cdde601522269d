"""map_p95_ms: the 95th percentile of every class map completed in the
window, each timed from the call until the map is on the host."""

from portbench.stats import percentile


def read(run):
    return 1e3 * percentile(run.latencies_s, 95)
