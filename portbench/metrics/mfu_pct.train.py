"""mfu_pct.train: the reference's forward and backward operations of
every step in the window over the window's seconds, as a share of the
card's peak in the compute dtype (989 TFLOP/s bf16)."""

from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run, "steps")
