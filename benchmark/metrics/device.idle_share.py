"""The share of the traced epochs' wall time in which no operation ran on
the device (the union of its operations' intervals), in %."""


def read(rec):
    t = rec["traced"]
    if not t or not t["epochs"]["busy_s"]:
        return None
    ep = t["epochs"]
    return 100.0 * (1.0 - ep["busy_s"] / ep["wall_s"])
