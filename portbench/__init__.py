"""portbench: the benchmark of fdt_torch, the PyTorch and CUDA port.

One command runs one cell of BENCHMARK.json once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are data: each
is a file of its own under portbench/, found by the name BENCHMARK.json
gives it.  Nothing here imports the JAX package or JAX.
"""
