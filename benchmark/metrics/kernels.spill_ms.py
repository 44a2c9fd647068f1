"""Device milliseconds an epoch launched inside the program's
``spmm.spill.*`` spans (the spill chain: the tband lane path's hub and cold
streams with their gathers, or the row merge and the take path), over the
spans profile's epochs (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    sp = spans.measure(rec)
    return spans.span_ms(sp["window"], "spmm.spill") / sp["epochs"] if sp else None
