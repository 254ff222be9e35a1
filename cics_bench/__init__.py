"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the CICS
day-ahead planner's rollouts, measured on the card and held against a plain
reference. ``run.py`` runs one cell of ``BENCHMARK.json``."""
