"""The benchmark of the PyTorch/CUDA port (``ccv_mppi_path_tracker_tpu_torch``).

The twin of the JAX package's ``bench.py``, ``scripts/bench_suite.py`` and
``scripts/profile_step.py``: seven cells on one NVIDIA card (``cells.py``),
their timing (``timing.py``), a separate traced run and the diagnostic
ladder (``trace.py``), and the benchmark's own count of the fused kernel's
work and its bound (``work.py``). Run ``python3 -m bench_torch --help``.

This directory is the benchmark's code: it stays fixed while later changes
to the package are measured with it. It imports torch and numpy and the
port's public entry points, never jax nor the JAX package.
"""
