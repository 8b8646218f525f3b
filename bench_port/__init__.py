"""Benchmark of the PyTorch/CUDA port (``repro_torch``): served retrieval
through the router at a leaf's corpus size.

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything a cell is made of is found by name: a configuration in
``configs/<name>.json`` (its index kind in ``indexes/<kind>.py``, the
plain reference of that kind in ``reference/<kind>.py``), a traffic mix
in ``traffic/<name>.json`` and each metric in ``metrics/<name>.py``.
Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
