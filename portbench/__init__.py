"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

One command runs one cell once (see ``README.md``)::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one model configuration, traffic mix, cell
limit or per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it (``manifest``).  Nothing here imports ``jax``
or the JAX package.
"""
