"""The benchmark of the PyTorch/CUDA port (``pbnet_torch``).

``python3 -m port_bench.run`` runs one cell of ``BENCHMARK.json``; see
``run.py``.  Nothing here imports JAX or the JAX package, and nothing under
``reference/`` imports the port.
"""
