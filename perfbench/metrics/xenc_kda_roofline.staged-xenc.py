"""``xenc_kda_roofline.staged-xenc``: the KDA kernel's least time over its device
time, in %. Its launches are found by name in the trace (``kda_layer``, one a KDA
layer and question; the kernel also applies the layer's convolutions, gates and
gated norm, which the least time leaves out); the least time of the traced window
(``lib/kda_work.kda_least_s``: q, k, v, g and o at 2 bytes and beta at 2 a head once
at the HBM rate, or 8 d^2 FLOPs a token, head and layer at the bf16 peak, the larger)
comes from the configuration's widths and the program's
``rerank_xenc_tokens_total``, and is shared over the launches."""

from perfbench.lib.kda_work import kda_least_s
from perfbench.lib.trace import kernel_ms_per_launch

KERNEL = "kda_layer"  # part of the kernel's name in the trace


def read(t):
    ms = kernel_ms_per_launch(t, KERNEL)
    launches = sum(c for name, c in t.op_n.items() if KERNEL in name)
    tokens = t.counters.get("rerank_xenc_tokens_total", 0.0)
    if not ms or not launches or not tokens or "linear_attn_config" not in t.config:
        return None
    return 100.0 * kda_least_s(t.config, tokens) * 1e3 / launches / ms
