"""Serving benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own (``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``), found by the name ``BENCHMARK.json`` gives it.
Nothing here imports JAX or the JAX package ``repro``.
"""
