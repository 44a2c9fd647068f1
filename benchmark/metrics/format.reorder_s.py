"""Host seconds of the port's reorder and the relabelling of the CSR."""


def read(rec):
    return rec["spans"].get("format.reorder_s")
