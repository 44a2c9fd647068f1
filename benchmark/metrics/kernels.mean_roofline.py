"""The least time of an epoch's mean aggregations (one fp32 SpMM at each
width of the reference's ``agg_widths``: bytes of X, Z and the graph's CSR
at the card's bandwidth, or 2 nnz d operations at its fp32 rate, the
larger; benchmark/roofline.py) over the device time an epoch launched
inside the program's ``spmm.*`` spans, the D^-1 scalings
(``spmm.scale.mean``) among them, in % (``benchmark/spans.py``).  None for
a reference without ``agg_widths``."""

from benchmark import roofline, spans


def read(rec):
    widths = getattr(rec["reference"], "agg_widths", None)
    sp = spans.measure(rec) if widths else None
    if not sp:
        return None
    ms = spans.span_ms(sp["window"], "spmm") / sp["epochs"]
    if not ms:
        return None
    peak = roofline.peaks(rec["device_kind"])
    least = sum(roofline.spmm_least_s(rec["nodes"], rec["nnz"], w, peak)
                for w in widths(rec["cfg"]))
    return 100.0 * least / (ms / 1e3)
