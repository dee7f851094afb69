"""MaxSim index: the token embeddings of each parent chunk, on the device.

The port of the JAX package's ``index/maxsim_index.py`` build and append. The store
is ``[P_pad, maxsim_doc_tokens, maxsim_dim]`` in the reference's storage dtype: int8
(``ops/maxsim.quantize_tokens``, the static x127 scale) under int8 and int4 dense
rows, bf16 under bf16 (rounded to nearest even, as ``jnp.asarray`` rounds), f32
otherwise. A token is masked in where its embedding has a non-zero component. The
store is filled an embedder batch at a time, so no full-corpus f32 staging buffer
is held. :meth:`MaxSimIndex.score_candidates` scores a query's candidate parents
(the staged rerank); the retriever hands the reranker an index over the placed
state's store, so the store is on the device once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import RAGConfig
from ..device import resolve_device
from ..ops.maxsim import maxsim_scores, quantize_tokens


def _store_dtype(embedding_dtype: str) -> torch.dtype:
    if embedding_dtype in ("int8", "int4"):
        return torch.int8
    return torch.bfloat16 if embedding_dtype == "bfloat16" else torch.float32


def _pack(block: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """f32 token rows (host) -> the storage dtype on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(block, dtype=np.float32)).to(device)
    return quantize_tokens(t) if dtype == torch.int8 else t.to(dtype)


@dataclass
class MaxSimIndex:
    tokens: torch.Tensor  # [P_pad, Td, D] token embeddings (zero rows = padding)
    mask: torch.Tensor  # bool[P_pad, Td]
    n_parents: int
    config: RAGConfig

    def append(self, new_tokens: np.ndarray) -> "MaxSimIndex":
        """Write new parents' token rows into spare capacity (growing to the next
        capacity multiple first when they do not fit). Returns a new index."""
        n_new = int(new_tokens.shape[0])
        if n_new == 0:
            return self
        new_total = self.n_parents + n_new
        p_pad = self.tokens.shape[0]
        if new_total > p_pad:
            p_pad = self.config.round_capacity(new_total)
        toks = self.tokens.new_zeros((p_pad,) + tuple(self.tokens.shape[1:]))
        toks[: self.tokens.shape[0]] = self.tokens
        mask = self.mask.new_zeros((p_pad, self.mask.shape[1]))
        mask[: self.mask.shape[0]] = self.mask
        td, d = toks.shape[1], toks.shape[2]
        rows = np.zeros((n_new, td, d), np.float32)
        t_avail = min(td, new_tokens.shape[1])
        d_avail = min(d, new_tokens.shape[2])
        rows[:, :t_avail, :d_avail] = new_tokens[:, :t_avail, :d_avail]
        toks[self.n_parents:new_total] = _pack(rows, toks.dtype, toks.device)
        mask[self.n_parents:new_total] = torch.from_numpy(np.any(rows != 0, axis=-1)).to(
            mask.device
        )
        return MaxSimIndex(tokens=toks, mask=mask, n_parents=new_total, config=self.config)

    def score_candidates(
        self, parent_rows: torch.Tensor, q_tokens: torch.Tensor, q_mask: torch.Tensor
    ) -> torch.Tensor:
        """f32[K] MaxSim scores of one query's candidate parent rows i[K] (-1
        invalid, scoring 0) against its tokens f32[Tq, D] with weights f32[Tq] (the
        reference's ``MaxSimIndex.score_candidates``): the MaxSim kernel on a CUDA
        store, whatever the reference's ``use_pallas`` says; the plain version on
        the CPU. The kernel gathers the candidates' rows from the store itself."""
        return maxsim_scores(
            self.tokens, self.mask, parent_rows[None, :], q_tokens[None], q_mask[None]
        )[0]


def build_maxsim_index(
    parent_texts: Sequence[str],
    token_embedder,  # token_embeddings(texts, dim=...) -> f32[N, T, <=D]
    config: RAGConfig,
    batch_size: int = 64,
    device=None,
) -> MaxSimIndex:
    """Token store of ``parent_texts`` on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    n = len(parent_texts)
    p_pad = config.round_capacity(max(n, 1))
    td = config.maxsim_doc_tokens
    d = config.maxsim_dim
    dtype = _store_dtype(config.embedding_dtype)
    toks = torch.zeros((p_pad, td, d), dtype=dtype, device=dev)
    mask = torch.zeros((p_pad, td), dtype=torch.bool, device=dev)
    for i in range(0, n, batch_size):
        batch = list(parent_texts[i : i + batch_size])
        emb = token_embedder.token_embeddings(batch, dim=d)  # [b, T, <=d]
        t_avail = min(td, emb.shape[1])
        d_avail = min(d, emb.shape[2])
        block = np.zeros((len(batch), td, d), np.float32)
        block[:, :t_avail, :d_avail] = emb[:, :t_avail, :d_avail]
        toks[i : i + len(batch)] = _pack(block, dtype, dev)
        mask[i : i + len(batch), :t_avail] = torch.from_numpy(
            np.any(emb[:, :t_avail] != 0, axis=-1)
        ).to(dev)
    return MaxSimIndex(tokens=toks, mask=mask, n_parents=n, config=config)
