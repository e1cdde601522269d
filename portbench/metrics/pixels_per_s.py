"""pixels_per_s: pixels classified in the window over its seconds (host
clock): every completed request's anchors, or every map's pixels."""

from portbench.stats import rate


def read(run):
    return rate(run.units["pixels"], run.window_s)
