"""``xenc_experts_roofline.staged-xenc``: the routed experts' least time a question
over their device time (``xenc_experts_ms``), in %. The least time
(``lib/xenc_work.experts_least_s``) is the larger of the routed multiply-adds of the
question's tokens (the program's ``rerank_xenc_tokens_total``) at the bf16 peak and
every expert's weights read once a layer at the HBM rate, from the configuration's
widths."""

from perfbench.lib.trace import stage_ms_per_unit
from perfbench.lib.xenc_work import experts_least_s, per_query


def read(t):
    ms = stage_ms_per_unit(t, "engine.staged.rerank.experts")
    n = per_query(t)
    if not ms or n is None:
        return None
    return 100.0 * experts_least_s(t.config, n["rerank_xenc_tokens_total"]) * 1e3 / ms
