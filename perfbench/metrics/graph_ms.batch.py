"""``graph_ms.batch``: device ms a batch in the engine's ``engine.graph`` range (the
k-hop walk and the chunk top-k)."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.graph")
