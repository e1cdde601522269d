"""Where a whole-scene map's logits are read on the program's timed path,
one module a reference (``portbench/taps/<reference>.py``): ``METHOD``,
the method of the served model whose return value holds the map's
logits, and ``logits_map(out, height, width)``, which lays that value out
as the reference's ``(height, width, classes)`` map.  The harness wraps
that method on the served model's instance and keeps what it returns; it
computes nothing of the program's and imports none of it."""
