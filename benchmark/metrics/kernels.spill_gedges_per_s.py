"""Spill edges the spill chain added over the spans profile's epochs (the
program's counter ``spmm.spill_edges``: the plan's spill edges each time
the chain runs) over the device seconds launched inside its
``spmm.spill.*`` spans, in billions a second (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    sp = spans.measure(rec)
    if not sp:
        return None
    ms = spans.span_ms(sp["window"], "spmm.spill")
    return sp["spill_edges"] / (ms / 1e3) / 1e9 if ms and sp["spill_edges"] else None
