"""``xenc_kimi_experts_roofline.staged-xenc``: Kimi-Linear's routed experts' least
time a question over their device time (``xenc_experts_ms``, the
``engine.staged.rerank.experts`` range), in %. The least time
(``lib/kda_work.experts_least_s``) is the larger of the routed multiply-adds over the
channels held here for the question's tokens (the program's
``rerank_xenc_tokens_total``, ``num_experts_per_token`` routes a token and expert
layer) at the bf16 peak and every expert's held channels read once a layer at the
HBM rate, from the configuration's widths and share."""

from perfbench.lib.kda_work import experts_least_s, per_query
from perfbench.lib.trace import stage_ms_per_unit


def read(t):
    ms = stage_ms_per_unit(t, "engine.staged.rerank.experts")
    n = per_query(t)
    if not ms or n is None or "expert_share" not in t.config:
        return None
    return 100.0 * experts_least_s(t.config, n["rerank_xenc_tokens_total"]) * 1e3 / ms
