"""vtbench: the benchmark of voxtracer_torch on one NVIDIA H100.

``python3 vtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration, traffic mix, metric and correctness limit is a file found by
its name (``configs/``, ``traffic/``, ``metrics/``, ``limits/``);
``reference/`` is the plain reference the outputs are compared with.
"""
