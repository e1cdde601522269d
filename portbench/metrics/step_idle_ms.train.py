"""step_idle_ms.train: milliseconds inside the program's train.step spans
in which nothing ran on the card, per traced step."""

from portbench.program_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ("train.step",), "steps")
