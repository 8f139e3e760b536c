"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 -m portbench.run`` runs one cell of ``BENCHMARK.json`` once on
the card; everything a cell needs is a data file or a small module found
here by name.  Nothing here imports JAX or the JAX package, and the
plain references under ``portbench/reference`` import nothing of the
program either.
"""
