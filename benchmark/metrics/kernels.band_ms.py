"""Device milliseconds an epoch launched inside the program's ``spmm.band``
spans (the band kernel's launches, the other buckets' scatters and the
zeroing of missing superwindows), over the spans profile's epochs
(``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    sp = spans.measure(rec)
    return spans.span_ms(sp["window"], "spmm.band") / sp["epochs"] if sp else None
