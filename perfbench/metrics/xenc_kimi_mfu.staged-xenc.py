"""``xenc_kimi_mfu.staged-xenc``: Kimi-Linear's model FLOPs a question over the
``engine.staged.rerank`` range's elapsed time a question at the bf16 peak, in %: the
whole rerank step's share of the chip's peak. The FLOPs (``lib/kda_work.model_flops``)
come from the configuration's widths and share and the program's counters (tokens,
causal pairs, prompts); the elapsed time is the device's busy time in the
range plus its idle time while the host was inside it."""

from perfbench.lib.kda_work import model_flops, per_query
from perfbench.lib.spans import idle_ms_per_unit
from perfbench.lib.trace import stage_ms_per_unit
from perfbench.lib.work import BF16_FLOPS

RANGE = "engine.staged.rerank"


def read(t):
    busy = stage_ms_per_unit(t, RANGE)
    n = per_query(t)
    if not busy or n is None or "linear_attn_config" not in t.config:
        return None
    elapsed_s = (busy + (idle_ms_per_unit(t, RANGE) or 0.0)) / 1e3
    return 100.0 * model_flops(t.config, n) / (elapsed_s * BF16_FLOPS)
