"""The least time of one fp32 SpMM at the cell's hidden width (bytes of X,
Z and the graph's CSR at the card's bandwidth, or 2 nnz d operations at
its fp32 rate, the larger; benchmark/roofline.py), over the device time
of one ``HybridSpMM.apply_padded`` call on the cell's operator, in %."""

from benchmark import roofline


def read(rec):
    t = rec["traced"]
    if not t or not t["spmm"]["busy_s"]:
        return None
    sp = t["spmm"]
    device_s = sum(sp["group_ms"].values()) / 1e3 / sp["calls"]
    least = roofline.spmm_least_s(rec["nodes"], rec["nnz"], rec["cfg"]["hidden"],
                                  roofline.peaks(rec["device_kind"]))
    return 100.0 * least / device_s
