"""Data parallelism over ``torch.distributed`` (port of
``dmfusion/parallel``; the ``data`` axis only)."""

from dmfusion_torch.parallel.mesh import (A14_ITEMS, Mesh,  # noqa: F401
                                          check_model, choose_backend,
                                          get_mesh,
                                          is_distributed,
                                          maybe_initialize_distributed,
                                          shutdown, unported,
                                          wants_distributed)
