"""gather_windows_roofline.span: B1 (csrc/gather_windows.cu) against its
bandwidth roofline, found by the program's b1.launch spans and not by the
kernel's name: the least bytes of the traced requests' family calls at
3.35 TB/s, over the device time of the kernels launched inside those
spans (their mirrors on the card: one kernel a span)."""

from portbench.program_spans import roofline_pct
from portbench.readers import gather_bytes


def read(run):
    return roofline_pct(run, "b1.launch", lambda launches: gather_bytes(run))
