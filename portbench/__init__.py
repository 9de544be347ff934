"""The benchmark of the PyTorch/CUDA port `admm_lstm_torch` on one H100.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line.  Configurations, traffic mixes, data sources and metrics are files
of their own under this folder, found by the names that `BENCHMARK.json`
gives (`spec.py`).
"""
