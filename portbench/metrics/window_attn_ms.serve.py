"""window_attn_ms.serve: device milliseconds launched inside the program's
swin.attn spans (the window-attention core: q, k and v split from the
fused projection through the product with v), per traced request."""

from portbench.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "swin.attn", "requests")
