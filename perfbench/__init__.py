"""The benchmark of the PyTorch and CUDA triad-census engine
(``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  Configurations, traffic mixes and metric readers
are files found by name: see ``perfbench/README.md``.
"""
