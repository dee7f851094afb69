"""``fusion_idle_ms.staged``: idle device ms a staged query while the host was inside
the program's ``engine.staged.fusion`` range (weighted RRF over the three
channels)."""

from perfbench.lib.spans import idle_ms_per_unit


def read(t):
    return idle_ms_per_unit(t, "engine.staged.fusion")
