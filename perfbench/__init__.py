"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once, from the checkout's
root::

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer
metric, kernel or model family sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``,
``work/<kernel>.py`` and ``reference/<family>.py``.
"""
