"""The retriever: a corpus snapshot's indexes on one device, and the staged query.

:class:`Retriever` is the port of the JAX package's ``Retriever``. It builds (or
takes) the BM25, dense, graph and MaxSim indexes of a corpus, the child -> parent
row table, the collection table and, when the dot rerank can be chosen, the
parents' mean embeddings, and places them as one
:class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState` on its device, which
the batched :class:`~triple_hybrid_rag_tpu_torch.engine.Engine` serves.

:meth:`Retriever.retrieve` is the staged single-query path, the reference's
default query path, in six steps with a host clock around each:

    1. plan            (host: the planner)
    2. three channels  (BM25, the exact dense scan, the k-hop graph walk)
    3. weighted RRF    (and conformal denoising when enabled)
    4. parent expand   (child rows -> parent rows)
    5. rerank          (MaxSim / dot / none, or a host callable over them)
    6. safety + denoise

Every channel reads the placed state, the engine's own tensors: nothing is placed
twice. On CUDA the bf16 and f32 dense scan launches the dense-scores kernel, the
term-table backend the term-table kernel and the MaxSim rerank the MaxSim kernel.
Kernels run asynchronously, so a stage's device time shows in the stage that next
reads a result on the host (the channel counts, the gate).

The helpers are ports of the reference's of the same names: MaxSim query-token
weights, the parents' mean embeddings of the dot rerank, and the decode of device
rows into :class:`~triple_hybrid_rag_tpu_torch.types.SearchResult` records.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .analyzer import Analyzer
from .config import RAGConfig, get_settings
from .corpus import CorpusStore
from .device import resolve_device
from .index.bm25_index import BM25Index, build_bm25_index, lexical_search
from .index.dense_index import (
    DenseIndex,
    build_dense_index,
    semantic_search,
    truncate_matryoshka,
)
from .index.graph_index import graph_search_plan
from .index.ivf import dequant_f32
from .index.maxsim_index import MaxSimIndex, build_maxsim_index
from .index.state import IndexState
from .models.embedder import get_default_embedder
from .models.planner import get_planner
from .models.reranker import Reranker, get_reranker
from .observability import rag_metrics
from .observability.trace import tracer
from .ops.fusion import (
    GRAPH_BIT,
    LEXICAL_BIT,
    SEMANTIC_BIT,
    FusedCandidates,
    apply_safety_denoise,
    conformal_denoise_mask,
    fuse_rrf,
    minmax_normalize,
)
from .ops.topk import NEG_INF, masked_top_k
from .types import QueryPlan, RetrievalResult, SearchResult

_EMPTY_CHANNEL_K = 1  # width of the placeholder lists of a channel that is off

# Content-light "function" words (EN + PT) that rarely match a document token and
# would drag the MaxSim mean below the safety threshold on natural questions; they
# get a soft weight instead of full voice.
_FUNCTION_WORDS = frozenset(
    """get got make made take took tell told know knew want need find found
    explain say said see saw look give gave show list use used work help
    obter fazer feito dizer dito saber quis querer preciso precisa mostrar
    ajudar usar achar encontrar funciona funcionar""".split()
)
FUNCTION_WORD_WEIGHT = 0.25

_FW_PROCESSED: dict = {}


def _function_words(analyzer: Analyzer) -> frozenset:
    """The function-word list in the analyzer's token space (cached per analyzer
    setting): both the surface forms and their stemmed/folded tokens."""
    key = (
        analyzer.config.analyzer_stemming,
        analyzer.config.analyzer_strip_accents,
        analyzer.config.analyzer_min_token_len,
    )
    fw = _FW_PROCESSED.get(key)
    if fw is None:
        out = set(_FUNCTION_WORDS)
        for word in _FUNCTION_WORDS:
            out.update(analyzer.tokenize(word))
        fw = frozenset(out)
        _FW_PROCESSED[key] = fw
    return fw


def maxsim_query_weights(text: str, analyzer: Analyzer, max_tokens: int) -> np.ndarray:
    """f32[max_tokens] per-query-token MaxSim weights (0 = padding slot), aligned
    with the embedder's ``token_embeddings`` positions."""
    fw = _function_words(analyzer)
    w = np.zeros((max_tokens,), np.float32)
    for j, t in enumerate(analyzer.tokenize(text)[:max_tokens]):
        w[j] = FUNCTION_WORD_WEIGHT if t in fw else 1.0
    return w


_ROW_BLOCK = 1 << 17  # rows dequantized at once (bounds the f32 transient)


def build_parent_embeddings(
    embeddings: torch.Tensor,
    scales: Optional[torch.Tensor],
    parent_rows: Union[Sequence[int], torch.Tensor],
    p_pad: int,
) -> torch.Tensor:
    """f32[p_pad, D] parent embeddings on the rows' device: each parent is the
    L2-normalized mean of its chunks' dequantized rows (the reference's
    ``Retriever._build_parent_embeddings``). ``parent_rows`` maps the first
    chunk rows to their parent; rows past it (padding) fall into the last parent
    slot, as in the reference."""
    dev = embeddings.device
    n = embeddings.shape[0]
    seg = torch.full((n,), p_pad - 1, dtype=torch.long, device=dev)
    rows = torch.as_tensor(parent_rows, dtype=torch.long, device=dev)
    seg[: rows.shape[0]] = rows
    dim = embeddings.shape[1] * (2 if embeddings.dtype == torch.uint8 else 1)
    sums = torch.zeros((p_pad, dim), dtype=torch.float32, device=dev)
    for lo in range(0, n, _ROW_BLOCK):
        hi = lo + _ROW_BLOCK
        block_scales = None if scales is None else scales[lo:hi]
        sums.index_add_(0, seg[lo:hi], dequant_f32(embeddings[lo:hi], block_scales))
    norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
    return sums / torch.clamp(norms, min=1e-12)


def decode_results(corpus, fused, rerank_scores, final_ids, final_scores) -> List[SearchResult]:
    """Host decode of one query: final rows -> SearchResult records. ``fused`` holds
    the query's candidate arrays (ids, rrf, lexical, semantic, graph, channels) as
    numpy; ``corpus`` is a view with ``child_by_row`` and ``parent``."""
    f_ids = np.asarray(fused.ids)
    slot_of = {int(cid): i for i, cid in enumerate(f_ids) if cid >= 0}
    rrf = np.asarray(fused.rrf)
    lex = np.asarray(fused.lexical)
    sem = np.asarray(fused.semantic)
    gr = np.asarray(fused.graph)
    chan = np.asarray(fused.channels)
    rk = np.asarray(rerank_scores)

    out: List[SearchResult] = []
    for cid, score in zip(np.asarray(final_ids), np.asarray(final_scores)):
        cid = int(cid)
        if cid < 0:
            continue
        child = corpus.child_by_row(cid)
        parent = corpus.parent(child.parent_id)
        slot = slot_of.get(cid)
        channels = []
        if slot is not None:
            bits = int(chan[slot])
            if bits & LEXICAL_BIT:
                channels.append("lexical")
            if bits & SEMANTIC_BIT:
                channels.append("semantic")
            if bits & GRAPH_BIT:
                channels.append("graph")
        out.append(
            SearchResult(
                chunk_id=child.chunk_id,
                parent_id=child.parent_id,
                doc_id=child.doc_id,
                text=child.text,
                parent_text=parent.text if parent else None,
                section_heading=child.section_heading,
                page_start=child.page_start,
                page_end=child.page_end,
                modality=child.modality,
                lexical_score=float(lex[slot]) if slot is not None else 0.0,
                semantic_score=float(sem[slot]) if slot is not None else 0.0,
                graph_score=float(gr[slot]) if slot is not None else 0.0,
                rrf_score=float(rrf[slot]) if slot is not None else 0.0,
                rerank_score=float(rk[slot]) if slot is not None else None,
                final_score=float(score),
                source_channels=tuple(channels),
            )
        )
    return out


def _parent_of_table(corpus: CorpusStore, config: RAGConfig) -> np.ndarray:
    """i32[n_pad] child row -> parent row, capacity-padded with 0."""
    n_pad = config.round_capacity(max(len(corpus), 1))
    parent_of = np.zeros((n_pad,), np.int32)
    rows = corpus.parent_rows()
    if rows:
        parent_of[: len(rows)] = rows
    return parent_of


class Retriever:
    """A corpus snapshot's indexes placed on one device, and the staged query."""

    def __init__(
        self,
        corpus: CorpusStore,
        config: Optional[RAGConfig] = None,
        embedder=None,
        planner=None,
        bm25_index: Optional[BM25Index] = None,
        dense_index: Optional[DenseIndex] = None,
        graph_index=None,
        reranker: Optional[Reranker] = None,
        child_embeddings: Optional[np.ndarray] = None,
        rerank_llm_fn=None,
        maxsim_index: Optional[MaxSimIndex] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        cfg = self.config = config or get_settings()
        self.corpus = corpus
        self.analyzer = Analyzer(cfg)
        self.embedder = embedder or get_default_embedder(cfg, device=self.device)
        self.planner = planner or get_planner(cfg)
        self.graph_index = graph_index

        texts = corpus.child_texts()
        if cfg.lexical_enabled and bm25_index is None:
            bm25_index = build_bm25_index(texts, cfg, self.analyzer)
        self.bm25_index = bm25_index
        if cfg.semantic_enabled and dense_index is None:
            vecs = child_embeddings if child_embeddings is not None else self.embedder.embed_texts(texts)
            dense_index = build_dense_index(vecs, cfg, self.device)
        self.dense_index = dense_index

        self.parent_of = _parent_of_table(corpus, cfg)
        self._init_collections(self.parent_of.shape[0])

        # the MaxSim token store over the parents (the primary rerank); a prebuilt
        # one (the ingestor's incremental store) skips the token-embedding pass
        self.maxsim_index = None
        if cfg.rerank_enabled and cfg.rerank_backend == "maxsim" and corpus.n_parents > 0:
            if maxsim_index is not None:
                self.maxsim_index = maxsim_index
            elif hasattr(self.embedder, "token_embeddings"):
                self.maxsim_index = build_maxsim_index(
                    corpus.parent_texts(), self.embedder, cfg, device=self.device
                )
        self.parent_emb = None
        if cfg.rerank_enabled and self.dense_index is not None and self.maxsim_index is None:
            self.parent_emb = self._build_parent_embeddings()
        self.corpus.mark_clean()
        self.state = self._place()
        self._init_reranker(reranker, rerank_llm_fn)

    @classmethod
    def from_indexes(
        cls,
        corpus: CorpusStore,
        config: RAGConfig,
        bm25_index: Optional[BM25Index] = None,
        dense_index: Optional[DenseIndex] = None,
        graph_index=None,
        maxsim_index: Optional[MaxSimIndex] = None,
        parent_of: Optional[np.ndarray] = None,
        embedder=None,
        planner=None,
        device=None,
    ) -> "Retriever":
        """A retriever over prebuilt indexes, none of them re-derived."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.config = config
        self.corpus = corpus
        self.analyzer = Analyzer(config)
        self.embedder = embedder or get_default_embedder(config, device=self.device)
        self.planner = planner or get_planner(config)
        self.bm25_index = bm25_index
        self.dense_index = dense_index
        self.graph_index = graph_index
        self.maxsim_index = maxsim_index
        self.parent_of = (
            np.asarray(parent_of, np.int32) if parent_of is not None
            else _parent_of_table(corpus, config)
        )
        self._init_collections(self.parent_of.shape[0])
        self.parent_emb = None
        if config.rerank_enabled and dense_index is not None and maxsim_index is None and len(corpus):
            self.parent_emb = self._build_parent_embeddings()
        self.state = self._place()
        self._init_reranker(None, None)
        return self

    @classmethod
    def from_state(
        cls,
        state: IndexState,
        embedder=None,
        planner=None,
    ) -> "Retriever":
        """The staged query over an index state already placed (the synthetic corpus
        built on the card, or an engine's state): no index object is kept and nothing
        is placed again. ``state.corpus`` decodes the results."""
        self = cls.__new__(cls)
        self.device = state.device
        self.config = state.config
        self.corpus = state.corpus
        self.analyzer = Analyzer(state.config)
        self.embedder = embedder or get_default_embedder(state.config, device=self.device)
        self.planner = planner or get_planner(state.config)
        self.bm25_index = self.dense_index = self.graph_index = self.maxsim_index = None
        self.collection_ids = dict(state.collection_ids)
        self.state = state
        self._init_reranker(None, None)
        return self

    def _init_reranker(self, reranker: Optional[Reranker], rerank_llm_fn) -> None:
        """The staged rerank over the placed state's MaxSim store or parent
        embeddings (the reference's ``get_reranker`` ladder). ``self.maxsim_view``
        is the store as placed, the one the engine reads."""
        cfg, st = self.config, self.state
        self.maxsim_view = None
        if (
            st.maxsim_tokens is not None and cfg.rerank_enabled and cfg.rerank_backend == "maxsim"
        ):
            n_parents = getattr(self.corpus, "n_parents", st.maxsim_tokens.shape[0])
            self.maxsim_view = MaxSimIndex(
                tokens=st.maxsim_tokens, mask=st.maxsim_mask, n_parents=n_parents, config=cfg
            )
        self.reranker = reranker or get_reranker(
            cfg,
            parent_embeddings=st.parent_emb,
            maxsim_index=self.maxsim_view,
            llm_fn=rerank_llm_fn,
            texts_of=self._parent_text_by_row if rerank_llm_fn is not None else None,
            maxsim_calibration=getattr(self.embedder, "maxsim_calibration", 1.0),
        )

    def _parent_text_by_row(self, row: int) -> str:
        """Parent row -> text (the host lookup of a callable reranker)."""
        if 0 <= row < self.corpus.n_parents:
            return self.corpus.parent_by_row(row).text
        return ""

    def _init_collections(self, n_pad: int) -> None:
        """The collection-id table of the child rows (-1 where the document is unknown)."""
        self.collection_ids = self.corpus.collection_ids()
        coll = np.full((n_pad,), -1, np.int32)
        rows = self.corpus.child_collection_rows()
        if rows:
            coll[: len(rows)] = rows
        self.collection_of = coll

    def _build_parent_embeddings(self) -> torch.Tensor:
        dx = self.dense_index
        p_pad = self.config.round_capacity(max(self.corpus.n_parents, 1))
        return build_parent_embeddings(dx.embeddings, dx.scales, self.corpus.parent_rows(), p_pad)

    def _place(self) -> IndexState:
        """The indexes as one :class:`IndexState` on the retriever's device. The dot
        rerank's parent embeddings go in only where the reference's reranker ladder
        picks that rung (``rerank_backend`` "maxsim" or "dot")."""
        cfg = self.config
        arrays: Dict[str, Any] = {"parent_of": self.parent_of, "collection_of": self.collection_of}
        host: Dict[str, Any] = {"collection_ids": self.collection_ids, "corpus": self.corpus}
        if self.bm25_index is not None:
            arrays.update(self.bm25_index.arrays())
            host["vocab"] = self.bm25_index.vocab
        dx = self.dense_index
        if dx is not None:
            arrays.update(embeddings=dx.embeddings, valid=dx.valid)
            if dx.scales is not None:
                arrays["dense_scales"] = dx.scales
        gx = self.graph_index
        if gx is not None:
            arrays.update(nbr=gx.nbr, chunk_entities=gx.chunk_entities)
            host.update(entity_store=gx.store, row_of=gx.row_of, seed_stop=gx.seed_stop)
        if self.maxsim_index is not None:
            arrays.update(maxsim_tokens=self.maxsim_index.tokens, maxsim_mask=self.maxsim_index.mask)
        if self.parent_emb is not None and cfg.rerank_backend in ("maxsim", "dot"):
            arrays["parent_emb"] = self.parent_emb
        state = IndexState.from_numpy(arrays, host, cfg, self.device)
        if gx is not None:
            gx.placed = state  # its device lookups read the placed tables
        return state

    # ------------------------------------------------------------------ staged query

    @torch.no_grad()
    def retrieve(
        self, query: str, top_k: Optional[int] = None, collection: Optional[str] = None
    ) -> RetrievalResult:
        """The staged query with per-stage host timings and decoded results."""
        cfg, st = self.config, self.state
        dev = self.device
        final_k = top_k or cfg.final_top_k
        timings: Dict[str, float] = {}
        t_total = time.perf_counter()

        # 1. plan
        t0 = time.perf_counter()
        plan = self.planner.plan(query, collection)
        timings["planning_ms"] = (time.perf_counter() - t0) * 1e3

        # 2. channels (optionally scoped to a collection)
        t0 = time.perf_counter()
        row_mask = self._collection_mask(collection)
        lex_ids, lex_scores = self._lexical_search(plan, row_mask)
        sem_ids, sem_scores, query_vec = self._semantic_search(plan, row_mask)
        gr_ids, gr_scores = self._graph_search(plan, row_mask)
        counts = torch.stack([(x >= 0).sum() for x in (lex_ids, sem_ids, gr_ids)]).tolist()
        channel_counts = dict(zip(("lexical", "semantic", "graph"), counts))
        timings["retrieval_ms"] = (time.perf_counter() - t0) * 1e3

        # 3. fusion
        t0 = time.perf_counter()
        weights = torch.tensor(
            [[
                plan.weights.get("lexical", cfg.lexical_weight),
                plan.weights.get("semantic", cfg.semantic_weight),
                plan.weights.get("graph", cfg.graph_weight),
            ]],
            dtype=torch.float32, device=dev,
        )
        fused = fuse_rrf(
            lex_ids[None], lex_scores[None], sem_ids[None], sem_scores[None],
            gr_ids[None], gr_scores[None], weights,
            rrf_k=cfg.rrf_k, top_k=cfg.rerank_top_k,
            score_blend=cfg.fusion_score_blend, lex_conf_gate=cfg.fusion_lex_conf_gate,
        )
        fused = FusedCandidates(*(x[0] for x in fused))
        if cfg.conformal_denoise_enabled:
            keep = conformal_denoise_mask(
                fused.ids[None], fused.rrf[None], torch.tensor(cfg.conformal_alpha)
            )[0]
            fused = fused._replace(ids=torch.where(keep, fused.ids, torch.full_like(fused.ids, -1)))
        timings["fusion_ms"] = (time.perf_counter() - t0) * 1e3

        # 4. parent expansion
        t0 = time.perf_counter()
        parent_ids = self._expand_to_parents(fused.ids)
        timings["expansion_ms"] = (time.perf_counter() - t0) * 1e3

        # 5. rerank
        t0 = time.perf_counter()
        if cfg.rerank_enabled:
            qctx: Dict[str, object] = {"query_text": query}
            if query_vec is not None:
                qctx["query_vec"] = query_vec
            if self.maxsim_view is not None:
                qctx.update(self._query_token_ctx(plan))
            rerank_scores = self.reranker.score(qctx, parent_ids, fused.rrf)
        else:
            rerank_scores = fused.rrf
        # the ordering score may fold the fused evidence back in; the gate below
        # still reads the pure rerank score
        b = cfg.rerank_blend_rrf
        if plan.requires_graph and plan.intent in ("relational", "entity_lookup"):
            # relation-mediated answers: trust the fused ranks more
            b = cfg.rerank_blend_rrf_relational
        if cfg.rerank_enabled and b > 0:
            order_scores = (1.0 - b) * rerank_scores + b * minmax_normalize(fused.ids, fused.rrf)
        else:
            order_scores = rerank_scores
        timings["rerank_ms"] = (time.perf_counter() - t0) * 1e3

        # 6. safety + denoise
        t0 = time.perf_counter()
        if cfg.safety_enabled or cfg.denoise_enabled:
            threshold = cfg.safety_threshold if cfg.safety_enabled else float("-inf")
            alpha = cfg.denoise_alpha if cfg.denoise_enabled else 0.0
            gate = apply_safety_denoise(
                fused.ids[None], order_scores[None],
                torch.tensor(threshold, dtype=torch.float32, device=dev),
                torch.tensor(alpha, dtype=torch.float32, device=dev),
                top_k=final_k, gate_scores=rerank_scores[None],
            )
            final_ids, final_scores = gate.ids[0], gate.scores[0]
            refused, max_score = bool(gate.refused[0]), float(gate.max_score[0])
        else:
            slots, final_scores = masked_top_k(
                torch.where(fused.ids >= 0, order_scores, torch.full_like(order_scores, NEG_INF)),
                final_k, invalid_score_floor=NEG_INF,
            )
            # slots are positions in the candidate list; map them to rows
            final_scores = torch.where(slots >= 0, final_scores, torch.zeros_like(final_scores))
            final_ids = torch.where(
                slots >= 0, fused.ids[slots.clamp(min=0)], torch.full_like(slots, -1)
            )
            refused, max_score = False, float(rerank_scores.max())
        timings["safety_ms"] = (time.perf_counter() - t0) * 1e3

        # decode on the host
        t0 = time.perf_counter()
        fused_np = FusedCandidates(*(x.cpu().numpy() for x in fused))
        results = decode_results(
            self.corpus, fused_np, rerank_scores.cpu().numpy(), final_ids.cpu().numpy(),
            final_scores.cpu().numpy(),
        )
        timings["decode_ms"] = (time.perf_counter() - t0) * 1e3
        timings["total_ms"] = (time.perf_counter() - t_total) * 1e3

        if cfg.metrics_enabled:
            rag_metrics.counter("retrieval_queries_total").inc()
            rag_metrics.histogram("retrieval_latency_ms").observe(timings["total_ms"])
            for ch, n in channel_counts.items():
                rag_metrics.counter("retrieval_channel_hits_total", "").inc(
                    n, labels={"channel": ch}
                )
            if refused:
                rag_metrics.counter("retrieval_refusals_total").inc()
            for stage, ms in timings.items():
                if stage != "total_ms":
                    tracer.stage(query[:64], stage, ms)

        return RetrievalResult(
            query=query,
            results=results,
            plan=plan,
            refused=refused,
            refusal_reason=(
                None
                if not refused
                else f"Max score {max_score:.2f} below threshold {cfg.safety_threshold}"
                if sum(channel_counts.values())
                else "No candidates retrieved"
            ),
            max_score=max_score,
            timings=timings,
            channel_counts=channel_counts,
        )

    # ------------------------------------------------------------------ channel stages

    def _empty_channel(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.full((_EMPTY_CHANNEL_K,), -1, dtype=torch.long, device=self.device),
            torch.zeros((_EMPTY_CHANNEL_K,), dtype=torch.float32, device=self.device),
        )

    def _lexical_search(self, plan: QueryPlan, row_mask: Optional[torch.Tensor] = None):
        if not self.config.lexical_enabled or self.state.vocab is None or not plan.keywords:
            return self._empty_channel()
        return lexical_search(self.state, plan.keywords, plan.lexical_top_k, row_mask)

    def _semantic_search(self, plan: QueryPlan, row_mask: Optional[torch.Tensor] = None):
        if not self.config.semantic_enabled or not self.state.has_dense:
            return (*self._empty_channel(), None)
        try:
            raw = self.embedder.embed_query(plan.semantic_query_text or plan.original_query)
        except Exception:
            # a failed embed (the encoder raises on a query with no tokens; an embed
            # server may be down) drops the semantic channel for this query only
            rag_metrics.counter("semantic_channel_failures_total").inc()
            return (*self._empty_channel(), None)
        qv = torch.from_numpy(truncate_matryoshka(raw[None], self.config.embedding_dim)[0])
        qv = qv.to(self.device)
        ids, scores = semantic_search(self.state, qv, plan.semantic_top_k, row_mask)
        return ids, scores, qv

    def _graph_search(self, plan: QueryPlan, row_mask: Optional[torch.Tensor] = None):
        if not self.config.graph_enabled or not self.state.has_graph or not plan.requires_graph:
            return self._empty_channel()
        return graph_search_plan(self.state, plan, row_mask)

    def _expand_to_parents(self, child_rows: torch.Tensor) -> torch.Tensor:
        parent_of = self.state.parent_of
        safe = child_rows.clamp(0, parent_of.shape[0] - 1)
        return torch.where(child_rows >= 0, parent_of.long()[safe], torch.full_like(safe, -1))

    def _collection_mask(self, collection: Optional[str]) -> Optional[torch.Tensor]:
        """bool[n_pad] row filter of a collection; None = unscoped. An unknown
        collection masks every row."""
        if collection is None:
            return None
        return self.state.collection_of == self.collection_ids.get(collection, -2)

    def _query_token_ctx(self, plan: QueryPlan) -> Dict[str, torch.Tensor]:
        """The query's MaxSim tokens and weights (the embedder that built the store)."""
        cfg = self.config
        text = plan.semantic_query_text or plan.original_query
        toks = self.embedder.token_embeddings(
            [text], max_tokens=cfg.maxsim_query_tokens, dim=cfg.maxsim_dim
        )[0]
        mask = np.any(toks != 0, axis=-1)
        weights = maxsim_query_weights(text, self.analyzer, cfg.maxsim_query_tokens) * mask.astype(
            np.float32
        )
        return {
            "q_tokens": torch.from_numpy(np.ascontiguousarray(toks, np.float32)).to(self.device),
            "q_mask": torch.from_numpy(weights).to(self.device),
        }


def retrieve(
    corpus: CorpusStore,
    query: str,
    top_k: Optional[int] = None,
    collection: Optional[str] = None,
    **kwargs,
) -> RetrievalResult:
    """One-shot staged query: ``top_k`` and ``collection`` go to the query, the other
    keyword arguments build the :class:`Retriever`."""
    return Retriever(corpus, **kwargs).retrieve(query, top_k=top_k, collection=collection)
