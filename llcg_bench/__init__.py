"""The benchmark of the PyTorch/CUDA port: a data-driven harness.

``python3 -m llcg_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  Cells,
configurations, traffic mixes, limits and per-layer metrics are files found
by name under this folder (see ``harness.py``).
"""
