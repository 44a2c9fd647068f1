"""Device milliseconds an epoch in every other kernel and copy:
elementwise, normalisation scaling, softmax, Adam, copies (group ``other``
of ``benchmark/kernels/*.json``), over the traced epochs."""

from benchmark import traces


def read(rec):
    return traces.group_ms_per_call(rec["traced"] and rec["traced"]["epochs"], "other")
