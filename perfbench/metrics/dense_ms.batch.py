"""``dense_ms.batch``: device ms a batch in the engine's ``engine.dense`` range, the
hand-written bucket-maxima kernel added by name."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.dense")
