"""Process start to the window's start: imports, graph, the port's
reorder, plan and upload, the kernel libraries, the checked steps and the
warm-up."""


def read(rec):
    return rec["setup_s"]
