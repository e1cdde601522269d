"""window_attn_roofline.span: the window-attention cores against their
bandwidth roofline, found by the program's swin.attn spans: the least
bytes of the traced requests' cores (q, k and v read once and the output
written once in the compute dtype, each call's bias table and mask read
once; portbench/attnbytes.py, from the reference's attention_calls) at
3.35 TB/s, over the device time launched inside those spans."""

from portbench import attnbytes, peaks, system
from portbench.program_spans import count, device_s


def read(run):
    if run.trace is None:
        return None
    spans = count(run.trace, "swin.attn")
    sec = device_s(run.trace, "swin.attn") if spans else None
    calls = getattr(system.reference(run.config), "attention_calls", None)
    anchors = run.traced_units.get("pixels")
    if sec is None or calls is None or not anchors:
        return None
    calls = calls(run.config)
    if spans % len(calls):
        return None
    moved = attnbytes.window_attention(calls, anchors, spans // len(calls),
                                       run.config["compute_dtype"])
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / sec
