"""``rerank_ms.staged``: device ms a staged query in the program's
``engine.staged.rerank`` range: the query tokens' copies, the MaxSim rerank and the
blend with the fused order."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.rerank")
