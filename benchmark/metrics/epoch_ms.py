"""The window's wall time, ended by a synchronise after the last epoch
issued, over the epochs issued in it."""


def read(rec):
    return rec["window"]["epoch_ms"]
