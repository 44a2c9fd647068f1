"""The model's operations an epoch (the ``epoch_flops`` of the
configuration's reference module, counted from the configuration and the
graph) over the traced run's window epoch time at the card's fp32 rate,
in %."""

from benchmark import roofline


def read(rec):
    if not rec["traced"] or rec["device_kind"] == "cpu":
        return None
    flops = rec["reference"].epoch_flops(rec["cfg"], rec["nodes"], rec["nnz"])
    peak = roofline.peaks(rec["device_kind"])["fp32_flops_per_s"]
    return 100.0 * flops / (rec["window"]["epoch_ms"] / 1e3 * peak)
