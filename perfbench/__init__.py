"""The benchmark of ``fugu_tpu_torch``: see ``BENCHMARK.json`` and
``perfbench/run.py``."""
