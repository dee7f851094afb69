"""``tokens_idle_ms.staged``: idle device ms a staged query while the host was inside
the program's ``engine.staged.tokens`` range (the MaxSim query tokens and weights
made on the host)."""

from perfbench.lib.spans import idle_ms_per_unit


def read(t):
    return idle_ms_per_unit(t, "engine.staged.tokens")
