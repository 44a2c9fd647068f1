"""Host seconds of the HybridSpMM construction (plan build and upload),
ended by a synchronise."""


def read(rec):
    return rec["spans"].get("format.plan_s")
