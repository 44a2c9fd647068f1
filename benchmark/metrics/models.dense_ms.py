"""Device milliseconds an epoch in GEMM kernels (cuBLAS, CUTLASS) (group ``dense`` of
``benchmark/kernels/*.json``), over the traced epochs."""

from benchmark import traces


def read(rec):
    return traces.group_ms_per_call(rec["traced"] and rec["traced"]["epochs"], "dense")
