"""train_samples_per_s: real (unpadded) anchors trained in the window over
its seconds (host clock); the window is whole epochs, each with its loss
fetch."""

from portbench.stats import rate


def read(run):
    return rate(run.units["samples"], run.window_s)
