"""The benchmark of the PyTorch/H100 port (``src/repro_torch``): FedCET
training rounds measured on one card and checked against a plain PyTorch
reference. ``python3 fedbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``."""
