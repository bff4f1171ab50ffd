"""The benchmark of ``romtime_tpu_torch`` on one H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once. Cells, configurations, traffic mixes
and per-layer metrics are files found by name under this folder.
"""
