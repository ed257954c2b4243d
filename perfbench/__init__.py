"""The benchmark of the encoder port ``x265_tpu_torch``: ``run.py`` runs
one cell of ``BENCHMARK.json`` once."""
