"""Reranker ``kimilinear`` (plain side): Kimi-Linear-48B-A3B-Instruct as an LLM
cross-encoder, holding the configuration's share of each routed expert's channels. Each of a query's
candidate parents is one prompt (the chat rung's), and its score is
``softmax(logit yes, logit no)[yes]`` at the prompt's last token.

The forward pass of the published description (``config.json`` of
moonshotai/Kimi-Linear-48B-A3B-Instruct, ``model_type`` kimi_linear; the Kimi Linear
technical report, arXiv:2510.26692; the gated delta rule of arXiv:2412.06464), in
plain PyTorch and float32 with TF32 off: no cache, no kernel, no chunking.

* Kimi Delta Attention (the layers of ``linear_attn_config.kda_layers``, counted from
  1): q, k, v each a projection, a causal depthwise convolution of width
  ``short_conv_kernel_size`` that reads only the same prompt's tokens, and SiLU; q
  and k L2-normalised per head (eps 1e-6); the log-decay
  ``g = -exp(A_log[h]) softplus(W_fb W_fa x + dt_bias)`` per channel; ``beta =
  sigmoid(W_b x)`` per head; then the recurrence token by token, one state f32[128,
  128] a prompt and head, zero at the prompt's start: ``S' = Diag(exp g_t) S``,
  ``S = S' + beta k (v - S'^T k)^T``, ``o = S^T q / sqrt(128)``
  (:func:`recurrence`, every prompt of the call stepped together); then the per-head
  RMSNorm of ``o`` times ``sigmoid(W_gb W_ga x)`` and the output projection.
* Latent attention (``full_attn_layers``) as DeepSeek-V3's with no rotation
  (``mla_use_nope``): the 64-wide parts stay, unrotated; scale 192^-0.5; one prompt
  at a time.
* Layer 1 a dense SwiGLU of ``intermediate_size``; the others the router over all
  ``num_experts`` (sigmoid in f32, the top ``num_experts_per_token`` chosen on the
  scores plus a selection bias, weighted by the unbiased scores renormalised and
  times ``routed_scaling_factor``), every expert in a loop over the channels of its
  width held here (the configuration's share, :data:`CHANNELS`: this chip's part of
  the routed sum under tensor parallelism), and the shared SwiGLU of
  ``num_shared_experts`` experts.

Departures from the published model, each shared with the program:

* random weights, drawn as the ``moonlight`` reference draws them (its
  ``tensor_seed`` and constants; upcycled experts, drawn whole and cut to the held
  channels), and for the KDA parameters the published code's own
  initialisations: ``A_log`` = log U(1, 16), ``dt_bias`` the inverse softplus of
  exp(U(log 1e-3, log 1e-1)) (floored at 1e-4), the convolutions U(-1/2, 1/2)
  (``nn.Conv1d``'s default bound for a fan-in of 4), the gated norm's weight 1.
  Matrices and convolutions are read rounded to bf16; ``A_log``, ``dt_bias`` and the
  selection bias stay f32. The selection bias (``e_score_correction_bias``, which the
  config implies by ``use_grouped_topk`` with one group, the DeepSeek-V3 convention)
  is N(0, 0.01);
* the stand-in tokenizer and documents of ``lib/prompts.py``.

It runs layer by layer over a call's prompts, drawing each layer's weights and
freeing them, so that beside the program's model on the card it fits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.lib.prompts import NO, YES, documents, prompt
from perfbench.reference.models.moonlight import BIAS_STD, INIT_STD, UPCYCLE_EPS, tensor_seed

# the configuration's model, as published (the catalog's copy of its config.json)
PUBLISHED = {
    "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu", "hidden_size": 2304,
    "intermediate_size": 9216, "kv_lora_rank": 512,
    "linear_attn_config": {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26],
        "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "model_max_length": 1048576, "model_type": "kimi_linear",
    "moe_intermediate_size": 1024, "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32, "num_expert_group": 1,
    "num_experts": 256, "num_experts_per_token": 8, "num_hidden_layers": 27,
    "num_key_value_heads": 32, "num_nextn_predict_layers": 0, "num_shared_experts": 1,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 10000, "routed_scaling_factor": 2.446,
    "tie_word_embeddings": False, "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
    "vocab_size": 163840,
}
DOCUMENTS = {"doc_tokens_min": 800, "doc_tokens_max": 1000}
CHANNELS = {"first": 0, "count": 512}  # the channels this chip holds of each routed expert's width
CONV_BOUND = 0.5  # U(-1/2, 1/2): 1 / sqrt(the convolution's fan-in of 4)
A_LOG_RANGE = (1.0, 16.0)  # A = exp(A_log) ~ U(1, 16)
DT_RANGE = (1e-3, 1e-1)  # dt log-uniform, floored at DT_FLOOR
DT_FLOOR = 1e-4
L2_EPS = 1e-6


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
               beta: torch.Tensor, lengths: Sequence[int], scale: float) -> torch.Tensor:
    """f32[N, H, D]: the delta rule token by token over prompts of ``lengths`` laid end
    to end in ``q``, ``k``, ``v``, ``g`` [N, H, D] and ``beta`` [N, H]; every prompt's
    state (zero at its start) stepped together, position by position; a prompt past
    its end keeps its state (decay 1, strength 0) and its outputs are dropped. A step
    reads the decayed state once for ``k`` and ``q`` together: ``o = S'^T q + u (k.q)``
    with ``u = beta (v - S'^T k)``, the same as ``S^T q`` after the write."""
    n_prompts, width = len(lengths), max(lengths)
    nh, d = q.shape[1], q.shape[2]

    def time_major(a: torch.Tensor) -> torch.Tensor:  # [width, prompts * heads, ...], zero past an end
        out = a.new_zeros((width, n_prompts) + tuple(a.shape[1:]))
        for b, part in enumerate(torch.split(a, list(lengths))):
            out[: part.shape[0], b] = part
        return out.reshape((width, n_prompts * nh) + tuple(a.shape[2:]))

    kq = time_major(torch.stack([k, q], dim=2).float())  # [W, BH, 2, D]
    vp, bp = time_major(v.float()), time_major(beta.float())
    ap = time_major(g.float()).exp()  # decay 1 past a prompt's end
    kq_dot = (kq[:, :, 0] * kq[:, :, 1]).sum(-1)
    s = torch.zeros((n_prompts * nh, d, d), dtype=torch.float32, device=q.device)  # [dk, dv]
    out = torch.empty((width, n_prompts * nh, d), dtype=torch.float32, device=q.device)
    for t in range(width):
        s.mul_(ap[t].unsqueeze(-1))
        r = torch.bmm(kq[t], s)  # [BH, 2, D]: S'^T k and S'^T q
        u = (vp[t] - r[:, 0]) * bp[t].unsqueeze(-1)
        s.baddbmm_(kq[t, :, 0].unsqueeze(-1), u.unsqueeze(1))
        out[t] = (r[:, 1] + u * kq_dot[t].unsqueeze(-1)) * scale
    out = out.view(width, n_prompts, nh, d)
    return torch.cat([out[:m, b] for b, m in enumerate(lengths)])


class Plain:
    """The model of ``cfg`` (published keys) with the weights of ``seed`` on ``device``,
    holding the channels ``channels`` (first, count) of each routed expert, read
    rounded to bf16 when ``bf16_weights``."""

    def __init__(self, cfg: dict, seed: int, device, bf16_weights: bool = True,
                 channels: Optional[Tuple[int, int]] = None) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.c = cfg
        self.seed = seed
        self.dev = torch.device(device)
        self.round = bf16_weights
        self.channels = (CHANNELS["first"], CHANNELS["count"]) if channels is None else channels
        lac = cfg["linear_attn_config"]
        self.kda_layers = {i - 1 for i in lac["kda_layers"]}
        self.heads, self.head_dim, self.conv = lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]

    # ---- weights ----

    def gen(self, name: str) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(tensor_seed(self.seed, name))

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen(name), device=self.dev, dtype=torch.float32)

    def uniform(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen(name), device=self.dev, dtype=torch.float32)

    def rounded(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float() if self.round else t

    def matrix(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        if ".mlp.experts." in name:  # upcycled: the layer's base plus the expert's own deviation
            base = self.normal(name.replace(".mlp.experts.", ".mlp.experts.base."), shape[1:])
            t = (base[None] + UPCYCLE_EPS * self.normal(name, shape)) * (
                INIT_STD / (1.0 + UPCYCLE_EPS ** 2) ** 0.5)
            first, count = self.channels  # the held channels: rows of gate and up, columns of down
            t = (t[:, :, first:first + count] if "down_proj" in name else t[:, first:first + count]).contiguous()
        else:
            t = self.normal(name, shape) * INIT_STD
        return self.rounded(t)

    def kda_weights(self, p: str) -> Dict[str, torch.Tensor]:
        h, width, hd = self.c["hidden_size"], self.heads * self.head_dim, self.head_dim
        a = p + "self_attn."
        w = {x: self.matrix(a + f"{x}_proj.weight", (width, h)) for x in ("q", "k", "v")}
        for x in ("q", "k", "v"):
            w[x + "_conv"] = self.rounded((self.uniform(a + f"{x}_conv1d.weight", (width, self.conv)) * 2 - 1)
                                          * CONV_BOUND)
        lo, hi = A_LOG_RANGE
        w["A_log"] = torch.log(self.uniform(a + "A_log", (self.heads,)) * (hi - lo) + lo)
        lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
        dt = torch.exp(self.uniform(a + "dt_bias", (width,)) * (hi - lo) + lo).clamp(min=DT_FLOOR)
        w["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
        w.update(f_a=self.matrix(a + "f_a_proj.weight", (hd, h)),
                 f_b=self.matrix(a + "f_b_proj.weight", (width, hd)),
                 b=self.matrix(a + "b_proj.weight", (self.heads, h)),
                 g_a=self.matrix(a + "g_a_proj.weight", (hd, h)),
                 g_b=self.matrix(a + "g_b_proj.weight", (width, hd)),
                 o=self.matrix(a + "o_proj.weight", (h, width)))
        return w

    def mla_weights(self, p: str) -> Dict[str, torch.Tensor]:
        c = self.c
        h, nh = c["hidden_size"], c["num_attention_heads"]
        nope, rope, vd, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
        return {
            "q": self.matrix(p + "self_attn.q_proj.weight", (nh * (nope + rope), h)),
            "kv_a": self.matrix(p + "self_attn.kv_a_proj_with_mqa.weight", (r + rope, h)),
            "kv_b": self.matrix(p + "self_attn.kv_b_proj.weight", (nh * (nope + vd), r)),
            "o": self.matrix(p + "self_attn.o_proj.weight", (h, nh * vd)),
        }

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        c = self.c
        h, p = c["hidden_size"], f"model.layers.{i}."
        w = self.kda_weights(p) if i in self.kda_layers else self.mla_weights(p)
        if i < c["first_k_dense_replace"]:
            f = c["intermediate_size"]
            w.update(gate=self.matrix(p + "mlp.gate_proj.weight", (f, h)),
                     up=self.matrix(p + "mlp.up_proj.weight", (f, h)),
                     down=self.matrix(p + "mlp.down_proj.weight", (h, f)))
            return w
        e, f = c["num_experts"], c["moe_intermediate_size"]
        s = c["num_shared_experts"] * f
        w.update(
            router=self.matrix(p + "mlp.gate.weight", (e, h)),
            bias=self.normal(p + "mlp.gate.e_score_correction_bias", (e,)) * BIAS_STD,
            e_gate=self.matrix(p + "mlp.experts.gate_proj.weight", (e, f, h)),
            e_up=self.matrix(p + "mlp.experts.up_proj.weight", (e, f, h)),
            e_down=self.matrix(p + "mlp.experts.down_proj.weight", (e, h, f)),
            gate=self.matrix(p + "mlp.shared_experts.gate_proj.weight", (s, h)),
            up=self.matrix(p + "mlp.shared_experts.up_proj.weight", (s, h)),
            down=self.matrix(p + "mlp.shared_experts.down_proj.weight", (h, s)),
        )
        return w

    # ---- the blocks (norm weights are 1) ----

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.c["rms_norm_eps"])

    def short_conv(self, x: torch.Tensor, w: torch.Tensor, lengths: Sequence[int]) -> torch.Tensor:
        """SiLU of the causal depthwise convolution of each prompt's own tokens:
        ``y_t = sum_m w[:, m] x_{t - (K - 1) + m}``, zero before the prompt's start."""
        kw, width = w.shape[1], max(lengths)
        xp = x.new_zeros((len(lengths), kw - 1 + width, x.shape[1]))  # each prompt after K - 1 zeros
        for b, part in enumerate(torch.split(x, list(lengths))):
            xp[b, kw - 1:kw - 1 + part.shape[0]] = part
        y = sum(w[:, m] * xp[:, m:m + width] for m in range(kw))
        return F.silu(torch.cat([y[b, :m] for b, m in enumerate(lengths)]))

    def kda(self, x: torch.Tensor, w: Dict[str, torch.Tensor], lengths: Sequence[int]) -> torch.Tensor:
        n, nh, hd = x.shape[0], self.heads, self.head_dim
        h = self.norm(x)
        q, k, v = (self.short_conv(h @ w[z].T, w[z + "_conv"], lengths).view(n, nh, hd) for z in "qkv")
        q = q * torch.rsqrt(q.pow(2).sum(-1, keepdim=True) + L2_EPS)
        k = k * torch.rsqrt(k.pow(2).sum(-1, keepdim=True) + L2_EPS)
        g = -w["A_log"].exp()[:, None] * F.softplus(((h @ w["f_a"].T) @ w["f_b"].T + w["dt_bias"]).view(n, nh, hd))
        beta = (h @ w["b"].T).sigmoid()
        o = recurrence(q, k, v, g, beta, lengths, hd ** -0.5)
        gate = ((h @ w["g_a"].T) @ w["g_b"].T).view(n, nh, hd).sigmoid()
        return x + (self.norm(o) * gate).reshape(n, nh * hd) @ w["o"].T

    def mla(self, x: torch.Tensor, w: Dict[str, torch.Tensor], lengths: Sequence[int]) -> torch.Tensor:
        """Latent attention with no rotation: the projections token by token, the
        causal attention one prompt at a time."""
        c = self.c
        n, nh = x.shape[0], c["num_attention_heads"]
        nope, rope, vd, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
        h = self.norm(x)
        q_all = (h @ w["q"].T).view(n, nh, nope + rope)
        a_all = h @ w["kv_a"].T
        kv_all = (self.norm(a_all[:, :r]) @ w["kv_b"].T).view(n, nh, nope + vd)
        out, lo = [], 0
        for m in lengths:
            q, a, kv = q_all[lo:lo + m], a_all[lo:lo + m], kv_all[lo:lo + m]
            lo += m
            k = torch.cat([kv[..., :nope], a[:, None, r:].expand(m, nh, rope)], dim=-1)
            s = torch.einsum("qhd,khd->hqk", q, k) * (nope + rope) ** -0.5
            causal = torch.ones(m, m, dtype=torch.bool, device=self.dev).tril()
            s = s.masked_fill(~causal, float("-inf")).softmax(dim=-1)
            out.append(torch.einsum("hqk,khd->qhd", s, kv[..., nope:]).reshape(m, nh * vd))
        return x + torch.cat(out) @ w["o"].T

    @staticmethod
    def swiglu(h: torch.Tensor, gate, up, down) -> torch.Tensor:
        return (F.silu(h @ gate.T) * (h @ up.T)) @ down.T

    def ffn(self, x: torch.Tensor, w: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
        c = self.c
        h = self.norm(x)
        if i < c["first_k_dense_replace"]:
            return x + self.swiglu(h, w["gate"], w["up"], w["down"])
        scores = (h @ w["router"].T).sigmoid()
        idx = (scores + w["bias"]).topk(c["num_experts_per_token"], dim=-1).indices
        wts = scores.gather(1, idx)
        if c["moe_renormalize"]:
            wts = wts / (wts.sum(dim=-1, keepdim=True) + 1e-20)
        wts = wts * c["routed_scaling_factor"]
        # the (token, expert) pairs grouped by expert, one read of the group sizes
        k = idx.shape[1]
        order = torch.argsort(idx.reshape(-1), stable=True)
        sizes = torch.bincount(idx.reshape(-1), minlength=c["num_experts"]).tolist()
        starts = np.cumsum([0] + sizes)
        routed = torch.zeros_like(h)
        for e in range(c["num_experts"]):
            pair = order[starts[e]:starts[e + 1]]
            if pair.numel():
                tok = pair // k
                y = self.swiglu(h[tok], w["e_gate"][e], w["e_up"][e], w["e_down"][e])
                routed.index_add_(0, tok, y * wts.reshape(-1)[pair, None])
        return x + (routed + self.swiglu(h, w["gate"], w["up"], w["down"]))

    def hidden(self, prompts: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """Each prompt's last-layer output [L, hidden] (before the final norm)."""
        c = self.c
        emb = self.matrix("model.embed_tokens.weight", (c["vocab_size"], c["hidden_size"]))
        lengths = [len(p) for p in prompts]
        x = emb[torch.tensor([t for p in prompts for t in p], dtype=torch.long, device=self.dev)]
        del emb
        for i in range(c["num_hidden_layers"]):
            w = self.layer(i)
            x = (self.kda if i in self.kda_layers else self.mla)(x, w, lengths)
            x = self.ffn(x, w, i)
            del w
        return list(torch.split(x, lengths))

    def logits(self, prompts: Sequence[Sequence[int]]) -> torch.Tensor:
        """f32[N, vocab]: every position's logits of the prompts laid end to end."""
        head = self.matrix("lm_head.weight", (self.c["vocab_size"], self.c["hidden_size"]))
        return self.norm(torch.cat(self.hidden(prompts))) @ head.T

    def yes_probability(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        head = self.matrix("lm_head.weight", (self.c["vocab_size"], self.c["hidden_size"]))[[YES, NO]]
        last = torch.stack([self.norm(x[-1]) for x in self.hidden(prompts)])
        return torch.softmax(last @ head.T, dim=-1)[:, 0].cpu().numpy()


class Reranker:
    def __init__(self, ref, seed: int) -> None:
        self.model = Plain(PUBLISHED, seed, ref.dev)
        self.cap = int(ref.cfg.get("rerank_max_candidates", 50))
        self.ids, self.lengths = documents(ref.c, dict(DOCUMENTS, vocab_size=PUBLISHED["vocab_size"]),
                                           seed, ref.dev)

    def scores(self, text: str, path: str, parents: np.ndarray, rrf: np.ndarray) -> np.ndarray:
        """f32[K]: the yes-probability of each of the K candidate parents (the first
        ``rerank_max_candidates``; 0 past them), each distinct parent judged once."""
        out = np.zeros(parents.size, np.float32)
        n = min(parents.size, self.cap)
        if n == 0:
            return out
        uniq, inverse = np.unique(parents[:n], return_inverse=True)
        vocab = PUBLISHED["vocab_size"]
        prompts = [prompt(text, self.ids[p, : int(self.lengths[p])].tolist(), vocab) for p in uniq]
        out[:n] = self.model.yes_probability(prompts)[inverse]
        return out


def build(ref, seed: int) -> Reranker:
    return Reranker(ref, seed)
