"""Device milliseconds an epoch in the program's own CUDA kernels (group ``spmm`` of
``benchmark/kernels/*.json``), over the traced epochs."""

from benchmark import traces


def read(rec):
    return traces.group_ms_per_call(rec["traced"] and rec["traced"]["epochs"], "spmm")
