"""gather_windows_roofline: B1 (csrc/gather_windows.cu) against its
bandwidth roofline: the least bytes of the traced requests' family calls
(every window written once, every scene byte the windows cover read once)
at 3.35 TB/s, over the kernel's device time."""

from portbench.readers import gather_bytes, roofline_pct


def read(run):
    return roofline_pct(run, "gather_family_kernel",
                        lambda launches: gather_bytes(run))
