"""The benchmark of ``ccv_mppi_path_tracker_tpu_torch`` on one H100: one cell
a run, ``python3 -m benchmark --workload NAME --seed N --seconds S --trace 0|1``
(see ``BENCHMARK.json`` and PERF.md)."""
