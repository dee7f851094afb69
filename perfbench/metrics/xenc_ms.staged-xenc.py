"""``xenc_ms.staged-xenc``: device ms a staged question in the program's
``engine.staged.rerank`` range under the cross-encoder: the prompts' copies and
gathers, the 27 layers, the head and the blend with the fused order."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.rerank")
