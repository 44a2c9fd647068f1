"""Host milliseconds a training step's call takes to return when issued
onto an empty queue (a synchronise before each), averaged over the
traced run's epochs timed for it.  Near ``epoch_ms``, the host sets the
pace."""


def read(rec):
    t = rec["traced"] and rec["traced"]["enqueue_ms"]
    return sum(t) / len(t) if t else None
