"""The benchmark of ``rec_pangu_tpu_torch`` on one NVIDIA H100: ``run.py``
runs one cell once; ``BENCHMARK.json`` at the checkout's root lists the
cells and metrics."""
