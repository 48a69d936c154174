"""The benchmark of biokanga_tpu_torch on one NVIDIA H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository root names the cells, the end-to-end and
the per-layer metrics; everything a cell needs is found by name under
this folder (spec.py).  Nothing here imports jax or biokanga_tpu.
"""
