"""``lexical_ms.staged``: device ms a staged query in the program's
``engine.staged.lexical`` range (BM25 over each term's whole postings, the top-k)."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.lexical")
