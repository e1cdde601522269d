"""groupnorm_ms.serve: device milliseconds of the fused GroupNorm kernel
(B5, csrc/group_norm_act.cu) per traced request, found by the program's
gn.launch spans: their mirrors on the card, one kernel a span (a ctypes
launch is linked to no torch operator, so model_ms.serve leaves it out)."""

from portbench.program_spans import count, launch_s


def read(run):
    n = run.traced_units.get("requests")
    if run.trace is None or not n or not count(run.trace, "gn.launch"):
        return None
    sec = launch_s(run.trace, "gn.launch")
    return None if sec is None else 1e3 * sec / n
