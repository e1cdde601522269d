"""host_copy_ms.serve: device milliseconds of host-to-card and
card-to-host copies a traced request (profiler trace)."""

from portbench.readers import host_copy_ms


def read(run):
    return host_copy_ms(run)
