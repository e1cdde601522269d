"""Drivers of the program, one a traffic ``entry``: ``setup(run)``,
``unit(run, st, timed, traced)`` (``timed``: a unit of the window, its
output kept for the check; ``traced``: a unit of the traced stretch, its
inputs kept for the readers), ``release``, ``check`` and ``unit_flops``
(the reference's operations of one unit, for ``mfu_pct.*``); see
``portbench/harness.py``."""
