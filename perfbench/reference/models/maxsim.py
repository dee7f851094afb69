"""Reranker ``maxsim`` (plain side): per query token the best doc token's dot
product over the parent's stored tokens (both in bf16, sums in f32), clipped at 0,
the weighted mean over the query's tokens (the embedder's ``tokens``). The store is
the generator's, read as the configuration stores it: bf16, or int8 codes worked
out again here."""

from __future__ import annotations

import numpy as np
import torch

NEG = float("-inf")
INT8_LEVELS = 127.0


def token_store_rows(tokens: torch.Tensor, parents: torch.Tensor, dtype: str, dev) -> torch.Tensor:
    """f32 doc tokens [K, Td, Dm] of ``parents`` as the configuration stores them:
    bf16, or int8 codes ``round(x * 127)`` read back as bf16(code * bf16(1/127))."""
    t = tokens[parents.to(tokens.device)].to(dev)
    if dtype in ("int8", "int4"):
        codes = torch.clamp(torch.round(t.float() * INT8_LEVELS), -INT8_LEVELS, INT8_LEVELS)
        inv = float(torch.tensor(1.0 / INT8_LEVELS, dtype=torch.bfloat16))
        return (codes * inv).to(torch.bfloat16).float()
    return t.to(torch.bfloat16).float()


class Reranker:
    def __init__(self, ref) -> None:
        self.ref = ref

    def scores(self, text: str, path: str, parents: np.ndarray, rrf: np.ndarray) -> np.ndarray:
        """f32[K] MaxSim scores of the K candidate ``parents``."""
        ref = self.ref
        q_tok, q_w = ref.tokens(text, path)
        if parents.size == 0:
            return np.zeros(0, np.float32)
        p = torch.from_numpy(parents).to(ref.dev)
        doc = token_store_rows(ref.c.tokens, p, ref.dtype, ref.dev)  # [K, Td, Dm]
        mask = ref.c.tok_mask[p.to(ref.c.tok_mask.device)].to(ref.dev)
        q = torch.from_numpy(q_tok).to(ref.dev).to(torch.bfloat16).float()
        sim = torch.einsum("ktd,qd->ktq", doc, q).masked_fill(~mask[..., None], NEG)
        per_q = sim.amax(dim=1)
        has = mask.any(dim=1)
        per_q = torch.where(has[:, None], per_q.clamp(min=0.0), torch.zeros_like(per_q))
        w = torch.from_numpy(q_w).to(ref.dev)
        score = (per_q * w[None, :]).sum(dim=1) / torch.clamp(w.sum(), min=1.0)
        return torch.where(has, score, torch.zeros_like(score)).cpu().numpy().astype(np.float32)


def build(ref, seed: int) -> Reranker:
    return Reranker(ref)
