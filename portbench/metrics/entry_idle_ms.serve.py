"""entry_idle_ms.serve: milliseconds inside the program's predict_ids or
class_map spans in which nothing ran on the card, per traced request."""

from portbench.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ("predict_ids", "class_map"), "requests")
