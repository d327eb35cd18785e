"""The benchmark of the PyTorch and CUDA port: ``run.py`` runs one cell of
``BENCHMARK.json``; see ``README.md``."""
