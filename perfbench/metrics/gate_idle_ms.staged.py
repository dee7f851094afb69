"""``gate_idle_ms.staged``: idle device ms a staged query while the host was inside
the program's ``engine.staged.gate`` range (the safety gate and denoise, and the
reads of the refusal and the top score)."""

from perfbench.lib.spans import idle_ms_per_unit


def read(t):
    return idle_ms_per_unit(t, "engine.staged.gate")
