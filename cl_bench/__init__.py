"""The benchmark of the port indic_cl_asr_torch: BENCHMARK.json names its
cells, metrics and bounds; ``python3 -m cl_bench.run`` runs one cell once."""
