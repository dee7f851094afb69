"""Rerankers: the precision stage over a query's fused candidates.

The port of the JAX package's ``models/reranker.py``. Every reranker has
``score(query_ctx, ids, fused_scores) -> f32[K]`` over the K candidate parent rows
(-1 invalid, scoring 0), on the candidates' device:

- :class:`~triple_hybrid_rag_tpu_torch.models.maxsim_reranker.MaxSimReranker`: the
  late-interaction MaxSim over the parents' stored token embeddings (the primary
  backend; the MaxSim kernel on CUDA);
- :class:`DotReranker`: the query against the parents' mean embeddings;
- :class:`NoopReranker`: the fused scores min-max normalised to [0, 1], order kept
  (the "rerank unavailable" rung, which keeps the 0.6 safety gate meaningful);
- :class:`~triple_hybrid_rag_tpu_torch.models.cross_encoder.CrossEncoderReranker`:
  an LLM cross-encoder on the device (``rerank_backend`` "cross_encoder"), over the
  document tokens and the model an index state holds;
- :class:`CallableReranker`: a host callable ``fn(query, texts) -> [0, 1] scores``
  (an LLM cross-encoder, say) over at most ``rerank_max_candidates`` candidates,
  falling back to its inner reranker on any failure.

:func:`get_reranker` is the reference's ladder: the callable over MaxSim, else the
dot rerank, else no rerank, by what is available; over a placed index state it is
the one place that maps ``rerank_backend`` and what the state holds to a rung.
:func:`query_context` is what a rung needs from a query before it scores.
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np
import torch

from ..config import RAGConfig, get_settings
from ..ops.fusion import minmax_normalize


class Reranker(Protocol):
    def score(
        self,
        query_ctx: dict,
        ids: torch.Tensor,  # i[K] candidate parent rows (-1 invalid)
        fused_scores: torch.Tensor,  # f32[K] fused RRF scores (the fallback signal)
    ) -> torch.Tensor:
        """f32[K] relevance scores, about [0, 1]; invalid slots 0."""
        ...


class NoopReranker:
    """Degradation rung: the fused order, min-max normalised to [0, 1]."""

    def __init__(self, config: Optional[RAGConfig] = None) -> None:
        self.config = config or get_settings()

    def score(self, query_ctx: dict, ids: torch.Tensor, fused_scores: torch.Tensor) -> torch.Tensor:
        return minmax_normalize(ids, fused_scores)


class DotReranker:
    """Query x parent-embedding cosine, rescaled from [-1, 1] to [0, 1]."""

    def __init__(self, parent_embeddings: torch.Tensor, config: Optional[RAGConfig] = None) -> None:
        self.parent_embeddings = parent_embeddings  # f32[P_pad, D] unit rows
        self.config = config or get_settings()

    def score(self, query_ctx: dict, ids: torch.Tensor, fused_scores: torch.Tensor) -> torch.Tensor:
        qv = query_ctx.get("query_vec")  # f32[D] unit
        if qv is None:
            # no query vector (the embedder failed): the fused order
            return minmax_normalize(ids, fused_scores)
        pe = self.parent_embeddings
        emb = pe[ids.long().clamp(0, pe.shape[0] - 1)]
        cos = emb @ qv.to(emb.dtype)
        return torch.where(ids >= 0, (cos + 1.0) * 0.5, torch.zeros_like(cos))


class CallableReranker:
    """A host callable ``fn(query, texts) -> scores in [0, 1]`` over the valid
    candidates' parent texts (``texts_of(row)``), in fused order and capped at
    ``rerank_max_candidates``; the rest score 0. Any failure (an exception, a
    result of the wrong shape) degrades to ``fallback``."""

    def __init__(self, fn, texts_of, fallback: Reranker, config: Optional[RAGConfig] = None):
        self.fn = fn
        self.texts_of = texts_of
        self.fallback = fallback
        self.config = config or get_settings()

    def score(self, query_ctx: dict, ids: torch.Tensor, fused_scores: torch.Tensor) -> torch.Tensor:
        ids_np = ids.cpu().numpy()
        query = query_ctx.get("query_text", "")
        try:
            # only valid candidates go to the model, the best first, at most the cap
            valid_pos = [j for j, i in enumerate(ids_np) if i >= 0]
            valid_pos = valid_pos[: max(1, int(self.config.rerank_max_candidates))]
            scores = np.zeros(ids_np.shape, np.float32)
            if valid_pos:
                texts = [self.texts_of(int(ids_np[j])) for j in valid_pos]
                raw = np.asarray(self.fn(query, texts), dtype=np.float32)
                if raw.shape != (len(valid_pos),):
                    raise ValueError("reranker returned wrong shape")
                scores[valid_pos] = np.clip(raw, 0.0, 1.0)
            return torch.from_numpy(scores).to(ids.device)
        except Exception:
            return self.fallback.score(query_ctx, ids, fused_scores)


def query_context(reranker: Reranker, query: str) -> dict:
    """What the rung (a callable's through its fallback) needs from a query, made in
    the caller's range before any call to ``score``, which a caller may wrap in a
    range of its own: the rung's ``query_context(query)`` where it has one, else {}."""
    make = getattr(getattr(reranker, "fallback", reranker), "query_context", None)
    return make(query) if make is not None else {}


def get_reranker(
    config: Optional[RAGConfig] = None,
    parent_embeddings: Optional[torch.Tensor] = None,
    maxsim_index=None,
    llm_fn=None,
    texts_of=None,
    maxsim_calibration: float = 1.0,
    state=None,
) -> Reranker:
    """The fallback ladder: llm -> maxsim (or the cross-encoder) -> dot -> noop, each
    rung taken when its inputs exist (``rerank_enabled=False`` means no rerank).
    ``state`` (a placed :class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState`)
    gives the inputs not passed: its MaxSim store, its parent embeddings, and the
    cross-encoder's document tokens and model."""
    config = config or get_settings()
    backend = config.rerank_backend if config.rerank_enabled else "none"
    if state is not None:
        if parent_embeddings is None:
            parent_embeddings = state.parent_emb
        if maxsim_index is None and backend == "maxsim" and state.maxsim_tokens is not None:
            from ..index.maxsim_index import MaxSimIndex

            maxsim_index = MaxSimIndex(
                tokens=state.maxsim_tokens, mask=state.maxsim_mask, config=config,
                n_parents=getattr(state.corpus, "n_parents", state.maxsim_tokens.shape[0]),
            )
    inner: Reranker
    if (backend == "cross_encoder" and state is not None and state.xenc_model is not None
            and state.xenc_doc_ids is not None):
        from .cross_encoder import CrossEncoderReranker

        inner = CrossEncoderReranker(state.xenc_model, state.xenc_doc_ids, state.xenc_doc_len, config)
    elif backend == "maxsim" and maxsim_index is not None:
        from .maxsim_reranker import MaxSimReranker

        inner = MaxSimReranker(maxsim_index, config, calibration=maxsim_calibration)
    elif backend in ("maxsim", "dot") and parent_embeddings is not None:
        inner = DotReranker(parent_embeddings, config)
    else:
        inner = NoopReranker(config)
    if llm_fn is not None and texts_of is not None:
        return CallableReranker(llm_fn, texts_of, inner, config)
    return inner
