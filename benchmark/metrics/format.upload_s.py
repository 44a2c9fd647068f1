"""Host seconds of the program's ``format.upload`` spans (the plan arrays'
host checks, table building and copies to the device) in the spans
profile's set-up, which builds the cell's program as the run's own set-up
does (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    sp = spans.measure(rec)
    return sp["setup"].get("format.upload") if sp else None
