"""Plain references of the benchmark's models, in float32 PyTorch.

Each configuration names its reference module by ``reference`` in its
file: ``portbench/reference/<name>.py``, with ``param_spec(config)``
(the configuration's parameters, from its widths) and the model's
mathematics.  They import torch alone, never the program under test nor
JAX.
"""
