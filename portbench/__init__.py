"""The benchmark of ``dmfusion_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python3 -m portbench.run --workload NAME --seed N --seconds
S --trace 0|1``.  See ``portbench/run.py`` and ``BENCHMARK.json``."""
