"""The cross-encoder's work, counted from the configuration's published widths and
the program's counters (prompts, tokens, causal pairs), never from the kernels that
run: the model FLOPs of a question and the least time of its routed experts.

A token's active weights are its multiply-adds outside attention's scores: the
latent attention's four projections in every layer, layer 0's dense MLP, and in each
expert layer the router, ``num_experts_per_tok`` routed experts and the shared ones.
Attention adds two operations per multiply-add over each causal pair (query key
width ``qk_nope + qk_rope``, value width ``v_head_dim``, every head, every layer). The
head computes two rows (yes, no) at each prompt's last token.
"""

from __future__ import annotations

from typing import Dict, Optional

from .work import BF16_FLOPS, HBM_BYTES_PER_S

COUNTERS = ("rerank_xenc_prompts_total", "rerank_xenc_tokens_total",
            "rerank_xenc_attention_pairs_total")


def active_weights(c: dict) -> Dict[str, float]:
    """Multiply-adds a token, by part, of the configuration ``c`` (published keys)."""
    h, nh = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    r, v = c["kv_lora_rank"], c["v_head_dim"]
    layers, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    moe, f = layers - dense, c["moe_intermediate_size"]
    return {
        "attention": layers * (h * nh * qk + h * (r + c["qk_rope_head_dim"]) + r * nh * (c["qk_nope_head_dim"] + v)
                               + nh * v * h),
        "dense": dense * 3 * h * c["intermediate_size"],
        "router": moe * h * c["n_routed_experts"],
        "routed": moe * c["num_experts_per_tok"] * 3 * h * f,
        "shared": moe * c["n_shared_experts"] * 3 * h * f,
    }


def per_query(t) -> Optional[Dict[str, float]]:
    """The counters' growth a question over the traced window; None where the program
    counted none (a program without the cross-encoder)."""
    got = {k: t.counters.get(k, 0.0) for k in COUNTERS}
    if not t.queries or not got["rerank_xenc_tokens_total"]:
        return None
    return {k: v / t.queries for k, v in got.items()}


def model_flops(c: dict, n: Dict[str, float]) -> float:
    """FLOPs a question: 2 x the active weights a token x tokens, the causal
    attention over the pairs, the two-row head a prompt."""
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn = 2.0 * c["num_hidden_layers"] * c["num_attention_heads"] * (qk + c["v_head_dim"])
    return (2.0 * sum(active_weights(c).values()) * n["rerank_xenc_tokens_total"]
            + attn * n["rerank_xenc_attention_pairs_total"]
            + 2.0 * 2 * c["hidden_size"] * n["rerank_xenc_prompts_total"])


def experts_least_s(c: dict, tokens: float) -> float:
    """The routed experts' least seconds for ``tokens``: their multiply-adds at the bf16
    peak, or every expert's weights read once a layer at the HBM rate, the larger."""
    moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    per = 3 * c["hidden_size"] * c["moe_intermediate_size"]
    ops = 2.0 * tokens * c["num_experts_per_tok"] * per * moe
    bytes_ = 2.0 * c["n_routed_experts"] * per * moe
    return max(ops / BF16_FLOPS, bytes_ / HBM_BYTES_PER_S)
