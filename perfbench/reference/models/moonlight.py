"""Reranker ``moonlight`` (plain side): Moonlight-16B-A3B as an LLM cross-encoder.
Each of a query's candidate parents is one prompt (the chat rung's: system prompt,
query, the parent's document, the question), and its score is
``softmax(logit yes, logit no)[yes]`` at the prompt's last token.

The forward pass of the published description (``config.json`` of
moonshotai/Moonlight-16B-A3B, ``model_type`` deepseek_v3, DeepSeek-V3's layer
equations, arXiv:2412.19437), in plain PyTorch and float32 with TF32 off: no cache, no padding, no kernel;
attention one prompt at a time, the steps that read one token alone (projections,
norms, MLPs, the router) over the call's tokens laid end to end, the routed experts
in a loop over the experts. It runs layer by layer over a call's prompts, drawing
each layer's weights and freeing them, so that beside the program's model on the
card it fits.

Departures from the published model, each shared with the program:

* random weights: no checkpoint is in the repository. Each tensor is drawn in f32
  from its own generator on the device, seeded by the first 8 bytes of SHA-256 of
  ``"<seed>\\0<name>"`` (63 bits), under the checkpoint's names (each layer's routed
  experts stacked): matrices N(0, 0.02), norm weights 1, and
  ``e_score_correction_bias`` N(0, 0.01), small and not zero so that the selection
  path that adds it is exercised. A layer's routed experts are upcycled (sparse
  upcycling, arXiv:2212.05055): each is the layer's base matrix (drawn under the
  name with ``mlp.experts.base.``) plus 0.03 of its own deviation, scaled by
  0.02 / sqrt(1.0009), so that a near-tied route that rounding flips changes little. They are read rounded to bf16 (the bias stays f32),
  the precision the program stores, so the comparison measures the computation and
  not the weights' rounding;
* the stand-in tokenizer of ``lib/prompts.py`` in place of the published one;
* documents made by ``lib/prompts.documents`` from the generator's terms and seeded
  filler (the configuration's ``documents``).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.lib.prompts import NO, YES, documents, prompt

# the configuration's model, as published (the catalog's copy of its config.json)
PUBLISHED = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 11264, "kv_lora_rank": 512,
    "max_position_embeddings": 8192, "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64, "n_shared_experts": 2,
    "norm_topk_prob": True, "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_theta": 50000, "routed_scaling_factor": 2.446,
    "scoring_func": "sigmoid", "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840,
}
DOCUMENTS = {"doc_tokens_min": 800, "doc_tokens_max": 1000}
INIT_STD, BIAS_STD, UPCYCLE_EPS = 0.02, 0.01, 0.03


def tensor_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}\x00{name}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class Plain:
    """The model of ``cfg`` (published keys) with the weights of ``seed`` on ``device``,
    read rounded to bf16 when ``bf16_weights``."""

    def __init__(self, cfg: dict, seed: int, device, bf16_weights: bool = True) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.c = cfg
        self.seed = seed
        self.dev = torch.device(device)
        self.round = bf16_weights

    # ---- weights ----

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        g = torch.Generator(device=self.dev).manual_seed(tensor_seed(self.seed, name))
        return torch.randn(tuple(shape), generator=g, device=self.dev, dtype=torch.float32)

    def matrix(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        if ".mlp.experts." in name:  # upcycled: the layer's base plus the expert's own deviation
            base = self.normal(name.replace(".mlp.experts.", ".mlp.experts.base."), shape[1:])
            t = (base[None] + UPCYCLE_EPS * self.normal(name, shape)) * (
                INIT_STD / (1.0 + UPCYCLE_EPS ** 2) ** 0.5)
        else:
            t = self.normal(name, shape) * INIT_STD
        return t.to(torch.bfloat16).float() if self.round else t

    def bias(self, name: str, n: int) -> torch.Tensor:
        return self.normal(name, (n,)) * BIAS_STD

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        c = self.c
        h, nh = c["hidden_size"], c["num_attention_heads"]
        nope, rope, vd, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
        p = f"model.layers.{i}."
        w = {
            "q": self.matrix(p + "self_attn.q_proj.weight", (nh * (nope + rope), h)),
            "kv_a": self.matrix(p + "self_attn.kv_a_proj_with_mqa.weight", (r + rope, h)),
            "kv_b": self.matrix(p + "self_attn.kv_b_proj.weight", (nh * (nope + vd), r)),
            "o": self.matrix(p + "self_attn.o_proj.weight", (h, nh * vd)),
        }
        if i < c["first_k_dense_replace"]:
            f = c["intermediate_size"]
            w.update(gate=self.matrix(p + "mlp.gate_proj.weight", (f, h)),
                     up=self.matrix(p + "mlp.up_proj.weight", (f, h)),
                     down=self.matrix(p + "mlp.down_proj.weight", (h, f)))
            return w
        e, f = c["n_routed_experts"], c["moe_intermediate_size"]
        s = c["n_shared_experts"] * f
        w.update(
            router=self.matrix(p + "mlp.gate.weight", (e, h)),
            bias=self.bias(p + "mlp.gate.e_score_correction_bias", e),
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

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """RoPE on [L, heads, d]: pair (2i, 2i + 1) turned by position * theta^(-2i/d),
        the turned evens first and the odds after (the published code's order)."""
        d = x.shape[-1]
        inv = 1.0 / (float(self.c["rope_theta"]) ** (torch.arange(0, d, 2, device=self.dev).float() / d))
        ang = torch.arange(x.shape[0], device=self.dev).float()[:, None] * inv[None, :]
        cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
        ev, od = x[..., 0::2], x[..., 1::2]
        return torch.cat([ev * cos - od * sin, od * cos + ev * sin], dim=-1)

    def attention(self, x: torch.Tensor, w: Dict[str, torch.Tensor], lengths: Sequence[int]) -> torch.Tensor:
        """Latent attention over the prompts laid end to end in ``x``: the projections
        token by token, the causal attention one prompt at a time."""
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
            q = torch.cat([q[..., :nope], self.rotate(q[..., nope:])], dim=-1)
            k = torch.cat([kv[..., :nope], self.rotate(a[:, None, r:]).expand(m, nh, rope)], dim=-1)
            s = torch.einsum("qhd,khd->hqk", q, k) * (nope + rope) ** -0.5
            causal = torch.ones(m, m, dtype=torch.bool, device=self.dev).tril()
            s = s.masked_fill(~causal, float("-inf")).softmax(dim=-1)
            out.append(torch.einsum("hqk,khd->qhd", s, kv[..., nope:]).reshape(m, nh * vd))
        return x + torch.cat(out) @ w["o"].T

    @staticmethod
    def swiglu(h: torch.Tensor, gate, up, down) -> torch.Tensor:
        return (torch.nn.functional.silu(h @ gate.T) * (h @ up.T)) @ down.T

    def routes(self, h: torch.Tensor, w: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(chosen experts [L, k], their weights [L, k]): chosen on the sigmoid scores
        plus the bias, weighted by the scores alone, normalised, scaled."""
        c = self.c
        scores = (h @ w["router"].T).sigmoid()
        idx = (scores + w["bias"]).topk(c["num_experts_per_tok"], dim=-1).indices
        wts = scores.gather(1, idx)
        if c["norm_topk_prob"]:
            wts = wts / (wts.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, wts * c["routed_scaling_factor"]

    def ffn(self, x: torch.Tensor, w: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
        h = self.norm(x)
        if i < self.c["first_k_dense_replace"]:
            return x + self.swiglu(h, w["gate"], w["up"], w["down"])
        idx, wts = self.routes(h, w)
        # the (token, expert) pairs grouped by expert, one read of the group sizes
        k = idx.shape[1]
        order = torch.argsort(idx.reshape(-1), stable=True)
        sizes = torch.bincount(idx.reshape(-1), minlength=self.c["n_routed_experts"]).tolist()
        routed = torch.zeros_like(h)
        start = 0
        for e, n in enumerate(sizes):
            if n:
                pair = order[start:start + n]
                tok = pair // k
                y = self.swiglu(h[tok], w["e_gate"][e], w["e_up"][e], w["e_down"][e])
                routed.index_add_(0, tok, y * wts.reshape(-1)[pair, None])
                start += n
        return x + (routed + self.swiglu(h, w["gate"], w["up"], w["down"]))

    def hidden(self, prompts: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """Each prompt's last-layer output [L, hidden] (before the final norm). The
        prompts lie end to end; only attention reads across tokens, one prompt at a
        time, so every other step runs over all the tokens at once."""
        c = self.c
        emb = self.matrix("model.embed_tokens.weight", (c["vocab_size"], c["hidden_size"]))
        lengths = [len(p) for p in prompts]
        x = emb[torch.tensor([t for p in prompts for t in p], dtype=torch.long, device=self.dev)]
        del emb
        for i in range(c["num_hidden_layers"]):
            w = self.layer(i)
            x = self.ffn(self.attention(x, w, lengths), w, i)
            del w
        return list(torch.split(x, lengths))

    def logits(self, prompt_ids: Sequence[int]) -> torch.Tensor:
        """f32[L, vocab]: every position's logits of one prompt."""
        head = self.matrix("lm_head.weight", (self.c["vocab_size"], self.c["hidden_size"]))
        return self.norm(self.hidden([prompt_ids])[0]) @ head.T

    def yes_probability(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        head = self.matrix("lm_head.weight", (self.c["vocab_size"], self.c["hidden_size"]))[[YES, NO]]
        last = torch.stack([self.norm(x[-1]) for x in self.hidden(prompts)])
        return torch.softmax(last @ head.T, dim=-1)[:, 0].cpu().numpy()


class Reranker:
    def __init__(self, ref, seed: int) -> None:
        self.ref = ref
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
