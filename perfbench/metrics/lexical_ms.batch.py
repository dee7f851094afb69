"""``lexical_ms.batch``: device ms a batch in the engine's ``engine.lexical`` range
(the BM25 channel: postings windows gathered, sorted by document, summed, the
top-k)."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.lexical")
