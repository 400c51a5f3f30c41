"""The benchmark of ``flacenc_tpu_torch`` on H100s: ``python3 -m
benchmark.run`` runs one cell of ``BENCHMARK.json`` (see ``run.py``).
It imports neither JAX nor the JAX package."""
