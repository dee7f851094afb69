"""``kernels_per_query.staged``: device operations (kernels, copies and sets) the
profiler records a staged query."""


def read(t):
    return t.device_ops / t.queries if t.queries and t.device_ops else None
