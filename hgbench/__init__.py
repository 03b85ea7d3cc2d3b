"""The benchmark of ``hashgan_tpu_torch`` (the PyTorch and CUDA port).

Run one cell from the root of a checkout:

    python3 hgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration in ``configs/``, its traffic mix in ``traffic/`` (the
parameters of one of the drivers in ``drivers/``), and each of its metrics
in ``metrics/``. The plain references that decide ``correct`` are in
``reference/``; they import nothing of the program.
"""
