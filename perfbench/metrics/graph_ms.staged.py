"""``graph_ms.staged``: device ms a staged query in the program's
``engine.staged.graph`` range (the k-hop walk and the chunk top-k), averaged over
every query, those without a graph plan included."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.graph")
