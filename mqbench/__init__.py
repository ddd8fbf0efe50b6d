"""The benchmark of the PyTorch and CUDA port (``chanamq_tpu_torch``).

``python3 mqbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints its result as the last line of standard output. Everything that
belongs to one configuration, traffic mix, entry kind or per-layer metric
is a file of its own (``configs/``, ``traffic/``, ``drivers/``,
``metrics/``), found by the name ``BENCHMARK.json`` gives it.
"""
