"""The retriever's indexes and the helpers of the query path.

:class:`Retriever` is the port of the JAX package's ``Retriever`` as it is built: it
builds (or takes) the BM25, dense, graph and MaxSim indexes of a corpus, the child
-> parent row table, the collection table and, when the dot rerank can be chosen,
the parents' mean embeddings, and places them as one
:class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState` on its device, which
the batched :class:`~triple_hybrid_rag_tpu_torch.engine.Engine` serves. Its staged
single-query path (``retrieve``) is not ported yet.

The helpers are ports of the reference's of the same names: MaxSim query-token
weights, the parents' mean embeddings of the dot rerank, and the decode of device
rows into :class:`~triple_hybrid_rag_tpu_torch.types.SearchResult` records.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .analyzer import Analyzer
from .config import RAGConfig, get_settings
from .corpus import CorpusStore
from .device import resolve_device
from .index.bm25_index import BM25Index, build_bm25_index
from .index.dense_index import DenseIndex, build_dense_index
from .index.ivf import dequant_f32
from .index.maxsim_index import MaxSimIndex, build_maxsim_index
from .index.state import IndexState
from .models.embedder import get_default_embedder
from .models.planner import get_planner
from .ops.fusion import GRAPH_BIT, LEXICAL_BIT, SEMANTIC_BIT
from .types import RetrievalResult, SearchResult

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
    """A corpus snapshot's indexes, placed on one device for the engine."""

    def __init__(
        self,
        corpus: CorpusStore,
        config: Optional[RAGConfig] = None,
        embedder=None,
        planner=None,
        bm25_index: Optional[BM25Index] = None,
        dense_index: Optional[DenseIndex] = None,
        graph_index=None,
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
            dense_index = build_dense_index(self.embedder.embed_texts(texts), cfg, self.device)
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
        return self

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
        return IndexState.from_numpy(arrays, host, cfg, self.device)

    def retrieve(
        self, query: str, top_k: Optional[int] = None, collection: Optional[str] = None
    ) -> RetrievalResult:
        """The staged single-query path (plan, channels, fusion, rerank, gate as
        separate steps) is not ported; the batched engine serves queries."""
        raise NotImplementedError(
            "Retriever.retrieve (the staged single-query path, with models/reranker.py "
            "and models/maxsim_reranker.py) is not ported yet (ROADMAP.md, Queue 1); "
            "serve queries through Engine.retrieve_batch"
        )
