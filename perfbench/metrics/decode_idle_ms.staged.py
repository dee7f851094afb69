"""``decode_idle_ms.staged``: idle device ms a staged query while the host was inside
the program's ``engine.staged.decode`` range (the copies back and the decode into
``SearchResult``s)."""

from perfbench.lib.spans import idle_ms_per_unit


def read(t):
    return idle_ms_per_unit(t, "engine.staged.decode")
