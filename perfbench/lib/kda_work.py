"""Kimi-Linear's work on the reranker's path, counted from the configuration's
published widths, the share of each routed expert's channels held here, and the
program's counters (prompts, tokens, causal pairs), never from the kernels that run.

* The KDA recurrence's least time: q, k, v, g and o at 2 bytes and beta at 2 a head,
  each read or written once a KDA layer, at the HBM rate; or its 8 d^2 FLOPs a
  token, head and layer (the decay, the state's read by k and by q, its rank-one
  write) at the bf16 peak; the larger.
* Model FLOPs a question: 2 x the multiply-adds a token outside the routed experts
  (the KDA layers' projections and convolutions, the latent attention's projections,
  the dense layer, the router over every expert, the shared expert), 2 x 3 x hidden x
  the held channels a route (every route, ``num_experts_per_token`` a token and expert
  layer), the recurrence's FLOPs, latent attention over the causal pairs in its
  layers, and the two-row head.
* The routed experts' least time: their multiply-adds over the held channels at the
  bf16 peak, or every expert's held channels read once a layer at the HBM rate, the
  larger.
"""

from __future__ import annotations

from typing import Dict, Optional

from .work import BF16_FLOPS, HBM_BYTES_PER_S

COUNTERS = ("rerank_xenc_prompts_total", "rerank_xenc_tokens_total", "rerank_xenc_attention_pairs_total")


def layers(c: dict) -> Dict[str, int]:
    lac = c["linear_attn_config"]
    return {"kda": len(lac["kda_layers"]), "mla": len(lac["full_attn_layers"]),
            "dense": c["first_k_dense_replace"], "moe": c["num_hidden_layers"] - c["first_k_dense_replace"]}


def kda_work(c: dict, tokens: float) -> Dict[str, float]:
    """The recurrence's bytes and FLOPs for ``tokens`` through every KDA layer."""
    lac = c["linear_attn_config"]
    d, heads, n = lac["head_dim"], lac["num_heads"], layers(c)["kda"]
    return {"bytes": (5 * 2 * d + 2) * heads * tokens * n, "flops": 8.0 * d * d * heads * tokens * n}


def kda_least_s(c: dict, tokens: float) -> float:
    w = kda_work(c, tokens)
    return max(w["bytes"] / HBM_BYTES_PER_S, w["flops"] / BF16_FLOPS)


def active_weights(c: dict) -> Dict[str, float]:
    """Multiply-adds a token, by part, outside the routed experts and the recurrence."""
    h, nh = c["hidden_size"], c["num_attention_heads"]
    lac = c["linear_attn_config"]
    hd, width = lac["head_dim"], lac["head_dim"] * lac["num_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    r, v = c["kv_lora_rank"], c["v_head_dim"]
    n = layers(c)
    kda = (3 * h * width + 3 * width * lac["short_conv_kernel_size"] + 2 * (h * hd + hd * width)
           + h * lac["num_heads"] + width * h)
    mla = h * nh * qk + h * (r + c["qk_rope_head_dim"]) + r * nh * (c["qk_nope_head_dim"] + v) + nh * v * h
    return {
        "kda": n["kda"] * kda,
        "mla": n["mla"] * mla,
        "dense": n["dense"] * 3 * h * c["intermediate_size"],
        "router": n["moe"] * h * c["num_experts"],
        "shared": n["moe"] * c["num_shared_experts"] * 3 * h * c["moe_intermediate_size"],
    }


def routed_work(c: dict, tokens: float) -> Dict[str, float]:
    """The routed experts' multiply-add FLOPs for ``tokens`` over the channels held
    here, and the bytes of those channels' bf16 weights read once a layer."""
    per = 3 * c["hidden_size"] * c["expert_share"]["channels_held"]
    moe = layers(c)["moe"]
    return {"flops": 2.0 * tokens * c["num_experts_per_token"] * per * moe,
            "bytes": 2.0 * c["num_experts"] * per * moe}


def experts_least_s(c: dict, tokens: float) -> float:
    w = routed_work(c, tokens)
    return max(w["flops"] / BF16_FLOPS, w["bytes"] / HBM_BYTES_PER_S)


def per_query(t) -> Optional[Dict[str, float]]:
    """The counters' growth a question over the traced window; None where the program
    counted no tokens."""
    got = {k: t.counters.get(k, 0.0) for k in COUNTERS}
    if not t.queries or not got["rerank_xenc_tokens_total"]:
        return None
    return {k: v / t.queries for k, v in got.items()}


def model_flops(c: dict, n: Dict[str, float]) -> float:
    """FLOPs a question (module docstring) from the counters ``n`` a question."""
    tokens = n["rerank_xenc_tokens_total"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn = 2.0 * layers(c)["mla"] * c["num_attention_heads"] * (qk + c["v_head_dim"])
    return (2.0 * sum(active_weights(c).values()) * tokens
            + routed_work(c, tokens)["flops"]
            + kda_work(c, tokens)["flops"]
            + attn * n["rerank_xenc_attention_pairs_total"]
            + 2.0 * 2 * c["hidden_size"] * n["rerank_xenc_prompts_total"])
