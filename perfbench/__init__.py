"""The benchmark of ``repro_torch`` on one or four NVIDIA GPUs.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one model configuration, traffic mix, cell or per-layer metric
is a file of its own under ``configs/``, ``traffic/``, ``workloads/`` and
``metrics/``, found by the name ``BENCHMARK.json`` gives it; the modules
beside them are shared by every cell.
"""
