"""copy_pct.train: share of the traced training device time under
aten::copy_ (the dense model's space-to-depth packing and casts), from
key_averages()."""

from portbench.readers import op_share_pct


def read(run):
    return op_share_pct(run, "aten::copy_")
