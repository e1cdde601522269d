"""phase_pool_roofline.span: B2 (csrc/phase_pool.cu) against its bandwidth
roofline, found by the program's b2.launch spans and not by the kernel's
name: one pool of the scene's trunk features a b2.launch span at 3.35
TB/s, over the device time of the kernels launched inside those spans
(their mirrors on the card: one kernel a span)."""

from portbench.program_spans import roofline_pct
from portbench.readers import pool_bytes


def read(run):
    return roofline_pct(run, "b2.launch",
                        lambda launches: launches * pool_bytes(run))
