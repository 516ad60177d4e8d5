"""PyTorch / CUDA port of ccv_mppi_path_tracker_tpu.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (``core/``, ``models/``, ``paths/``, ``ops/``,
``kernels/``, ``solver/``, ``runtime/``, ``metrics/``). It carries the MPPI
control update of the four models (unicycle, steering_unicycle,
rate_limited_steering, full_body), with elite sampling, through the fused
rollout/cost/update kernel (``kernels/rollout_cost.py``, CUDA source in
``csrc/rollout_cost.cu``) or the eager path, and the closed loop that repeats
it.

Importing the package imports torch and numpy only; the kernel is built with
``nvcc`` at its first launch on a CUDA tensor.
"""
