"""Benchmark of ``image_denoising_tpu_torch`` on an NVIDIA H100.

``python3 -m gpubench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout and prints its result as the last line of standard output.
Configurations, traffic mixes, limits and per-layer metric readers are
files found by name (``configs/``, ``traffic/``, ``limits/``,
``metrics/``); the drivers of each kind of traffic are in ``kinds/``.
"""
