"""The benchmark of hcspmm_tpu_torch: ``python3 benchmark/run.py``; cells
and metrics are named in ``BENCHMARK.json`` at the root of the checkout."""
