"""model_ms.serve: device milliseconds launched inside the program's
model.forward spans (the served model's forward, or a map's dense pass),
per traced request."""

from portbench.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "model.forward", "requests")
