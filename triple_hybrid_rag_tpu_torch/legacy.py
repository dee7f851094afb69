"""RAG 1.0 legacy path: flat chunking + un-weighted dual-hybrid search.

The port of the JAX package's ``legacy.py``. The first-generation pipeline stays
available as a fallback: a flat character chunker (1000 chars / 200 overlap,
table-atomic) and :class:`HybridSearcher`, a vector channel and a BM25 channel fused
with *un-weighted* RRF ``1/(k + rank + 1)`` that keeps each chunk's best raw score
per channel.

- :class:`FlatChunker` — single-level character chunking with the 1.0 parameters,
- :class:`HybridSearcher` — dual-channel search over the same indexes with the 1.0
  fusion formula (note the ``rank + 1`` offset: 0-indexed ranks, unlike RAG 2.0's
  1-indexed ``w/(k + rank)``).

The searcher's indexes live on one device (CUDA unless ``device="cpu"``): its BM25
index is placed there once (``BM25Index.placed``), and on the card its dense channel
over bf16 or f32 rows launches the dense-scores kernel once per query. "Legacy" is a
scoring/shape contract, not a separate storage stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .analyzer import Analyzer
from .chunker import RecursiveSplitter, extract_tables, restore_tables
from .config import RAGConfig, get_settings
from .corpus import CorpusStore
from .device import resolve_device
from .index.bm25_index import BM25Index, build_bm25_index
from .index.dense_index import DenseIndex, build_dense_index, truncate_matryoshka
from .models.embedder import BowHashEmbedder, Embedder
from .types import ChildChunk, ParentChunk, SearchResult


@dataclass
class FlatChunker:
    """Single-level chunker with RAG 1.0 parameters (chars, not tokens)."""

    chunk_chars: int = 1000
    overlap_chars: int = 200

    def chunk_document(self, text: str, doc_id: str) -> Tuple[List[ParentChunk], List[ChildChunk]]:
        """Returns (parents, children) where each chunk is its own parent — the flat
        structure expressed in the 2.0 two-level schema so all machinery applies."""
        doc_key = doc_id[:16]
        masked, tables = extract_tables(text)
        splitter = RecursiveSplitter(
            chunk_tokens=max(1, self.chunk_chars // 4),
            overlap_tokens=self.overlap_chars // 4,
        )
        parents: List[ParentChunk] = []
        children: List[ChildChunk] = []
        for i, piece in enumerate(splitter.split_text(masked)):
            body = restore_tables(piece, tables)
            parents.append(
                ParentChunk(
                    parent_id=f"{doc_key}:{i}", doc_id=doc_id, parent_idx=i, text=body,
                    token_count=max(1, len(body) // 4),
                )
            )
            children.append(
                ChildChunk(
                    chunk_id=f"{doc_key}:{i}:0", parent_id=f"{doc_key}:{i}",
                    doc_id=doc_id, parent_idx=i, child_idx=0, text=body,
                    token_count=max(1, len(body) // 4),
                )
            )
        return parents, children


@dataclass
class LegacySearchConfig:
    """RAG 1.0 search knobs."""

    top_k: int = 5
    vector_top_k: int = 20
    bm25_top_k: int = 20
    rrf_k: int = 60
    min_score: float = 0.0


class HybridSearcher:
    """RAG 1.0 dual-hybrid search over the indexes of a corpus on one device."""

    def __init__(
        self,
        corpus: CorpusStore,
        config: Optional[RAGConfig] = None,
        search_config: Optional[LegacySearchConfig] = None,
        embedder: Optional[Embedder] = None,
        bm25_index: Optional[BM25Index] = None,
        dense_index: Optional[DenseIndex] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or get_settings()
        self.search_config = search_config or LegacySearchConfig()
        self.corpus = corpus
        self.analyzer = Analyzer(self.config)
        self.embedder = embedder or BowHashEmbedder(
            dim=self.config.embedding_dim_full, config=self.config
        )
        texts = corpus.child_texts()
        self.bm25_index = bm25_index or build_bm25_index(texts, self.config, self.analyzer)
        if dense_index is None:
            dense_index = build_dense_index(
                self.embedder.embed_texts(texts), self.config, self.device
            )
        self.dense_index = dense_index

    def search_query(self, query: str, top_k: Optional[int] = None) -> List[SearchResult]:
        sc = self.search_config
        k = top_k or sc.top_k

        # both channels are queued on the device before either is read back
        lex_ids, lex_scores = self.bm25_index.search(
            self.analyzer.tokenize(query), sc.bm25_top_k, device=self.device
        )
        qv = truncate_matryoshka(
            self.embedder.embed_query(query)[None], self.config.embedding_dim
        )[0]
        sem_ids, sem_scores = self.dense_index.search(
            torch.from_numpy(qv).to(self.device), sc.vector_top_k
        )

        # un-weighted RRF 1/(k + rank + 1), keeping best per-channel scores
        fused: Dict[int, Dict] = {}
        for channel, (ids, scores) in (
            ("bm25", (lex_ids, lex_scores)),
            ("vector", (sem_ids, sem_scores)),
        ):
            ids_np, scores_np = ids.cpu().numpy(), scores.cpu().numpy()
            for rank, (cid, s) in enumerate(zip(ids_np, scores_np)):
                if cid < 0:
                    continue
                entry = fused.setdefault(
                    int(cid),
                    # -inf sentinels: a 0.0 init clamped legitimate NEGATIVE
                    # cosine scores, misreporting channel provenance
                    {"rrf": 0.0, "bm25": -np.inf, "vector": -np.inf, "channels": []},
                )
                entry["rrf"] += 1.0 / (sc.rrf_k + rank + 1)
                entry[channel] = max(entry[channel], float(s))
                entry["channels"].append(channel)

        for data in fused.values():  # absent channel -> 0.0 (not -inf) in results
            for ch in ("bm25", "vector"):
                if data[ch] == -np.inf:
                    data[ch] = 0.0
        ranked = sorted(fused.items(), key=lambda kv: -kv[1]["rrf"])
        out: List[SearchResult] = []
        for cid, data in ranked:
            if data["rrf"] < sc.min_score:
                continue
            child = self.corpus.child_by_row(cid)
            parent = self.corpus.parent(child.parent_id)
            out.append(
                SearchResult(
                    chunk_id=child.chunk_id,
                    parent_id=child.parent_id,
                    doc_id=child.doc_id,
                    text=child.text,
                    parent_text=parent.text if parent else None,
                    section_heading=child.section_heading,
                    lexical_score=data["bm25"],
                    semantic_score=data["vector"],
                    rrf_score=data["rrf"],
                    final_score=data["rrf"],
                    source_channels=tuple(dict.fromkeys(data["channels"])),
                )
            )
            if len(out) >= k:
                break
        return out
