"""Device milliseconds an epoch launched inside the program's ``spmm.scale``
spans (each SpMM's two D^-1/2 scalings, forward and backward), over the
spans profile's epochs (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    sp = spans.measure(rec)
    return spans.span_ms(sp["window"], "spmm.scale") / sp["epochs"] if sp else None
