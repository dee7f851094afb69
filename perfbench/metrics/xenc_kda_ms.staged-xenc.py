"""``xenc_kda_ms.staged-xenc``: device ms a staged question in Kimi-Linear's
``engine.staged.rerank.kda`` ranges: each KDA layer's input norm, projections,
convolutions, gates, the chunked recurrence's kernel, the gated norm and the output
projection, over every KDA layer. None for a model without KDA layers."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.rerank.kda")
