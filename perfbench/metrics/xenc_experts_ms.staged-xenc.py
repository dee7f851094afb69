"""``xenc_experts_ms.staged-xenc``: device ms a staged question in the
cross-encoder's ``engine.staged.rerank.experts`` ranges: the (token, expert) pairs
sorted by expert, the routed experts' grouped GEMMs and the weighted combine, over
every expert layer."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.rerank.experts")
