"""phase_pool_roofline: B2 (csrc/phase_pool.cu) against its bandwidth
roofline: the bytes of its traced launches (one pool of the scene's trunk
features each) at 3.35 TB/s, over their device time."""

from portbench.readers import pool_bytes, roofline_pct


def read(run):
    return roofline_pct(run, "phase_pool_kernel",
                        lambda launches: launches * pool_bytes(run))
