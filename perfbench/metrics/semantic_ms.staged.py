"""``semantic_ms.staged``: device ms a staged query in the program's
``engine.staged.semantic`` range (the query vector's copy, the dense scan, the
top-k)."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.semantic")
