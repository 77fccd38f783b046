"""The benchmark of cudf_tpu_torch on one NVIDIA GPU.

``run.py`` runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON result line; ``README.md`` gives the
command and the file layout. Nothing here imports ``jax`` or ``cudf_tpu``.
"""
