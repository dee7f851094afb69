"""``xenc_attention_ms.staged-xenc``: device ms a staged question in the
cross-encoder's ``engine.staged.rerank.attention`` ranges: the input norm, the latent
attention's projections, RoPE, the padding, causal attention and the output
projection, over every layer."""

from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    return stage_ms_per_unit(t, "engine.staged.rerank.attention")
