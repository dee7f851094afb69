"""Ingestion: file -> corpus -> indexes.

The port of the JAX package's ``Ingestor`` (``ingest.py``):

    1. SHA-256 file hash                          -> idempotency key
    2. skip a document already completed in its collection (the same bytes in
       another collection become a distinct document with a collection-scoped id)
    3. register the document, status 'processing'
    4. load (``loader.py``; OCR for scans and images)
    5. hierarchical chunk (``chunker.py``: stable ids, page provenance)
    6. bulk embed (``FailSoftEmbedder``: failed items become zero vectors and are
       listed in its ``last_errors``)
    7. store the chunks (content-hash dedup per collection)
    8. entity extraction per parent, with bounded retries; a parent that still
       fails is skipped
    9. status 'completed', or 'failed' on any exception (the result says why)

Index building is separate: :meth:`Ingestor.build_indexes` derives the indexes
from the corpus, incrementally where it can (dense and MaxSim rows are appended
into spare capacity on the device), and :meth:`Ingestor.make_retriever` places them.
The reference's counters go to ``observability.rag_metrics``: documents skipped,
ingested and failed, chunks stored, ingest time, and parents whose entity
extraction failed. The default loader is OCR-capable (the ``ocr_glyph`` ladder), so
PDF, office and image files ingest as the reference's do.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .chunker import HierarchicalChunker
from .config import RAGConfig, get_settings
from .corpus import CorpusStore
from .device import resolve_device
from .index.bm25_index import BM25Index, build_bm25_index
from .index.dense_index import DenseIndex, build_dense_index
from .index.graph_index import GraphIndex, build_graph_index
from .index.maxsim_index import MaxSimIndex, build_maxsim_index
from .loader import DocumentLoader
from .models.embedder import FailSoftEmbedder, get_default_embedder
from .models.entity_extractor import EntityStore, RuleBasedExtractor
from .observability.metrics import rag_metrics
from .retrieval import Retriever
from .types import (
    ChildChunk,
    Document,
    IngestionResult,
    IngestionStatus,
    LoadedDocument,
    ParentChunk,
)

ProgressFn = Callable[[str, float], None]  # (stage, fraction) callback


def hash_file(path: str | Path, chunk_size: int = 1 << 20) -> str:
    """Streamed SHA-256 (reference ingest.py:165,204)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_size)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


class Ingestor:
    """Host-side ingestion pipeline writing into a CorpusStore + EntityStore."""

    def __init__(
        self,
        corpus: Optional[CorpusStore] = None,
        config: Optional[RAGConfig] = None,
        embedder=None,
        loader: Optional[DocumentLoader] = None,
        extractor=None,
        entity_store: Optional[EntityStore] = None,
        ner_retries: int = 3,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or get_settings()
        self.corpus = corpus or CorpusStore()
        self.embedder = FailSoftEmbedder(
            embedder or get_default_embedder(self.config, device=self.device)
        )
        if loader is None:
            # OCR-capable by default: HTTP vision (when configured) -> pytesseract ->
            # built-in glyph recognizer -> no OCR (the ocr_glyph ladder)
            from .ocr import OCRProcessor
            from .ocr_glyph import get_default_ocr_fn

            ocr_fn = get_default_ocr_fn(self.config)
            loader = DocumentLoader(
                ocr_processor=OCRProcessor(ocr_fn) if ocr_fn is not None else None
            )
        self.loader = loader
        self.chunker = HierarchicalChunker(self.config)
        self.extractor = extractor or RuleBasedExtractor(self.config)
        self.entity_store = entity_store or EntityStore()
        self.ner_retries = ner_retries
        self.embeddings: Dict[str, np.ndarray] = {}  # chunk_id -> full-dim embedding
        self._dense_cache: Optional[DenseIndex] = None  # incremental-append target
        self._maxsim_cache: Optional[MaxSimIndex] = None  # incremental MaxSim store

    # ------------------------------------------------------------------

    def ingest_file(
        self,
        path: str | Path,
        collection: str = "default",
        force: bool = False,
        progress: Optional[ProgressFn] = None,
    ) -> IngestionResult:
        path = Path(path)
        timings: Dict[str, float] = {}
        t_start = time.perf_counter()

        def tick(stage: str, frac: float) -> None:
            if progress:
                progress(stage, frac)

        # 1-2: hash + idempotency. The key is (collection, content hash) like the
        # reference's unique (org_id, hash_sha256) (rag2/ingest.py:204-222): the same
        # bytes ingested under a second collection become a DISTINCT document with a
        # collection-scoped id — previously they were silently skipped and tenant B
        # could never retrieve them.
        t0 = time.perf_counter()
        doc_id = hash_file(path)
        timings["hash_ms"] = (time.perf_counter() - t0) * 1e3
        existing = self.corpus.documents.get(doc_id)
        if existing is not None and existing.collection != collection:
            doc_id = hashlib.sha256(f"{collection}:{doc_id}".encode()).hexdigest()
            existing = self.corpus.documents.get(doc_id)
        if existing is not None and existing.status == IngestionStatus.COMPLETED and not force:
            rag_metrics.counter("ingest_skipped_total").inc()
            return IngestionResult(
                doc_id=doc_id, filename=path.name,
                status=IngestionStatus.COMPLETED, skipped=True, timings=timings,
            )

        # 3: register
        doc = Document(
            doc_id=doc_id, filename=path.name, collection=collection,
            status=IngestionStatus.PROCESSING,
        )
        self.corpus.register_document(doc, force=True)
        tick("registered", 0.1)

        try:
            # 4: load
            t0 = time.perf_counter()
            loaded = self.loader.load(path)
            doc.file_type = loaded.file_type
            doc.n_pages = len(loaded.pages)
            timings["load_ms"] = (time.perf_counter() - t0) * 1e3
            tick("loaded", 0.3)

            # 5: chunk (page map from page char offsets)
            t0 = time.perf_counter()
            text, page_map = self._assemble_text(loaded)
            parents, children = self.chunker.chunk_document(text, doc_id, page_map)
            timings["chunk_ms"] = (time.perf_counter() - t0) * 1e3
            tick("chunked", 0.45)

            # 6: embed children (bulk, degradation to zero vectors on failure)
            t0 = time.perf_counter()
            vectors = self.embedder.embed_texts([c.text for c in children])
            timings["embed_ms"] = (time.perf_counter() - t0) * 1e3
            tick("embedded", 0.65)

            # 7: store with dedup
            t0 = time.perf_counter()
            add = self.corpus.add_chunks(parents, children)
            for child, vec in zip(children, vectors):
                if child.row >= 0:  # row assigned = actually stored (not deduped)
                    self.embeddings[child.chunk_id] = vec
            timings["store_ms"] = (time.perf_counter() - t0) * 1e3
            tick("stored", 0.75)

            # 8: NER per parent with bounded retries; failures recorded, not fatal
            n_ent = n_rel = n_men = 0
            failed_parents: List[str] = []
            if self.config.ner_enabled:
                t0 = time.perf_counter()
                by_parent: Dict[str, List[ChildChunk]] = {}
                for c in children:
                    by_parent.setdefault(c.parent_id, []).append(c)
                for parent in parents:
                    stats = self._extract_with_retry(parent, by_parent.get(parent.parent_id, []))
                    if stats is None:
                        failed_parents.append(parent.parent_id)
                        continue
                    n_ent += stats["entities"]
                    n_rel += stats["relations"]
                    n_men += stats["mentions"]
                timings["ner_ms"] = (time.perf_counter() - t0) * 1e3
            tick("extracted", 0.95)

            # 9: status
            doc.status = IngestionStatus.COMPLETED
            doc.n_parents = add.added_parents
            doc.n_children = add.added_children
            timings["total_ms"] = (time.perf_counter() - t_start) * 1e3
            rag_metrics.counter("ingest_documents_total").inc()
            rag_metrics.counter("ingest_chunks_total").inc(add.added_children)
            rag_metrics.histogram("ingest_duration_ms").observe(timings["total_ms"])
            tick("completed", 1.0)
            return IngestionResult(
                doc_id=doc_id, filename=path.name, status=IngestionStatus.COMPLETED,
                n_pages=doc.n_pages, n_parents=add.added_parents,
                n_children=add.added_children, n_deduped=add.deduped_children,
                n_entities=n_ent, n_relations=n_rel, n_mentions=n_men,
                timings=timings,
                error=f"NER failed for {len(failed_parents)} parents" if failed_parents else None,
            )
        except Exception as e:
            doc.status = IngestionStatus.FAILED
            rag_metrics.counter("ingest_failed_total").inc()
            timings["total_ms"] = (time.perf_counter() - t_start) * 1e3
            return IngestionResult(
                doc_id=doc_id, filename=path.name, status=IngestionStatus.FAILED,
                error=f"{type(e).__name__}: {e}", timings=timings,
            )

    def ingest_directory(
        self, directory: str | Path, pattern: str = "*", **kwargs
    ) -> List[IngestionResult]:
        """Bulk ingestion (reference scripts/ingest_rag2.py directory mode)."""
        out = []
        for p in sorted(Path(directory).rglob(pattern)):
            if p.is_file():
                out.append(self.ingest_file(p, **kwargs))
        return out

    def ingest_text(
        self, text: str, name: str = "inline.txt", collection: str = "default",
        force: bool = False,
    ) -> IngestionResult:
        """Direct text ingestion (no file) — convenience for library users."""
        with tempfile.NamedTemporaryFile(
            "w", suffix=Path(name).suffix or ".txt", prefix=Path(name).stem + "-",
            delete=False, encoding="utf-8",
        ) as f:
            f.write(text)
            tmp = f.name
        try:
            res = self.ingest_file(tmp, collection=collection, force=force)
            res.filename = name
            doc = self.corpus.documents.get(res.doc_id)
            if doc is not None and not res.skipped:
                doc.filename = name  # not the randomized temp-file name
            return res
        finally:
            os.unlink(tmp)

    # ------------------------------------------------------------------

    def build_indexes(
        self, with_graph: Optional[bool] = None, incremental: bool = True
    ) -> Tuple[Optional[BM25Index], Optional[DenseIndex], Optional[GraphIndex]]:
        """Derive device indexes from the current corpus snapshot.

        The dense index updates *incrementally* when the corpus only grew since the
        last build: new rows write into spare device capacity (DenseIndex.append, no
        recompile). The lexical arrays rebuild (vocabulary and df are global
        statistics a row append cannot patch)."""
        cfg = self.config
        texts = self.corpus.child_texts()
        bm25 = build_bm25_index(texts, cfg) if cfg.lexical_enabled else None
        dense = None
        # The staging matrix is sized by the embedder's ACTUAL output width, not
        # cfg.embedding_dim_full: the packaged trained encoder is 1024-native while
        # the config default (2048) describes the reference's API model — sizing by
        # config crashed `RAG()` out of the box (regression test: test_ingest.py
        # test_default_encoder_dim_mismatch). Matryoshka truncation to
        # cfg.embedding_dim happens inside build_dense_index either way.
        dim_full = int(getattr(self.embedder, "dim", 0) or cfg.embedding_dim_full)
        if cfg.semantic_enabled:
            cached = self._dense_cache if incremental else None
            if cached is not None and (
                cached.dim != cfg.embedding_dim or cached.n_docs > len(self.corpus)
            ):
                cached = None  # config changed or corpus rebuilt: full build
            if cached is not None:
                new_children = self.corpus.children[cached.n_docs :]
                self._backfill_embeddings(new_children)
                new_vecs = np.zeros((len(new_children), dim_full), np.float32)
                for i, c in enumerate(new_children):
                    v = self.embeddings.get(c.chunk_id)
                    if v is not None:
                        new_vecs[i] = v
                dense = cached.append(new_vecs)
            else:
                self._backfill_embeddings(self.corpus.children)
                vecs = np.zeros((len(self.corpus), dim_full), np.float32)
                for c in self.corpus.children:
                    v = self.embeddings.get(c.chunk_id)
                    if v is not None:
                        vecs[c.row] = v
                dense = build_dense_index(vecs, cfg, self.device)
            self._dense_cache = dense
        graph = None
        if (with_graph if with_graph is not None else cfg.graph_enabled):
            graph = build_graph_index(self.entity_store, self.corpus, cfg)
        self.corpus.mark_clean()
        return bm25, dense, graph

    def _backfill_embeddings(self, children) -> None:
        """Embed chunks this Ingestor never embedded itself (a pre-populated or
        restored corpus passed into the constructor): without this, build_indexes
        silently left ZERO vectors for every pre-existing chunk and the semantic
        channel could not see old content. Fail-soft: an embed failure leaves the
        zero rows (lexical/graph still answer)."""
        missing = [c for c in children if c.chunk_id not in self.embeddings]
        if not missing:
            return
        try:
            vecs = np.asarray(
                self.embedder.embed_texts([c.text for c in missing]), np.float32
            )
        except Exception:
            return
        for c, v in zip(missing, vecs):
            self.embeddings[c.chunk_id] = v

    def make_retriever(self, **kwargs):
        """Corpus -> ready Retriever (indexes built from this ingestor's state and
        placed on its device)."""
        bm25, dense, graph = self.build_indexes()
        kwargs.setdefault("maxsim_index", self._maxsim_index())
        return Retriever(
            self.corpus, self.config,
            embedder=self.embedder.inner,
            bm25_index=bm25, dense_index=dense, graph_index=graph, device=self.device,
            **kwargs,
        )

    def _maxsim_index(self):
        """Incremental MaxSim token store (mirrors the dense cache): adding one
        document to a large corpus must not re-run token_embeddings over EVERY
        parent — the dominant encoder cost of a rebuild. Appends new parents
        into spare capacity; falls back to a full build when the config changed
        or the corpus shrank."""
        cfg = self.config
        emb = self.embedder.inner if hasattr(self.embedder, "inner") else self.embedder
        if not (
            cfg.rerank_enabled
            and cfg.rerank_backend == "maxsim"
            and hasattr(emb, "token_embeddings")
            and self.corpus.n_parents > 0
        ):
            self._maxsim_cache = None
            return None
        cached = self._maxsim_cache
        if cached is not None and (
            cached.config != cfg or cached.n_parents > self.corpus.n_parents
        ):
            cached = None
        if cached is not None:
            new_parents = self.corpus.parents[cached.n_parents :]
            if new_parents:
                toks = emb.token_embeddings(
                    [p.text for p in new_parents], dim=cfg.maxsim_dim
                )
                cached = cached.append(np.asarray(toks, np.float32))
        else:
            cached = build_maxsim_index(self.corpus.parent_texts(), emb, cfg, device=self.device)
        self._maxsim_cache = cached
        return cached

    # ------------------------------------------------------------------

    @staticmethod
    def _assemble_text(loaded: LoadedDocument) -> Tuple[str, List[Tuple[int, int, int]]]:
        parts: List[str] = []
        page_map: List[Tuple[int, int, int]] = []
        pos = 0
        for page in loaded.pages:
            t = page.text or ""
            parts.append(t)
            page_map.append((pos, pos + len(t), page.page_number))
            pos += len(t) + 2  # the "\n\n" join separator
        return "\n\n".join(parts), page_map

    def _extract_with_retry(
        self, parent: ParentChunk, children: Sequence[ChildChunk]
    ) -> Optional[Dict[str, int]]:
        delay = 0.0
        for attempt in range(self.ner_retries):
            try:
                result = self.extractor.extract(parent, children)
                return self.entity_store.store_extraction(result)
            except Exception:
                # exponential backoff 2s -> 10s (reference tenacity ladder,
                # rag2/ingest.py:466-472); the cap is config so unit tests run fast
                delay = min(2.0 * (2**attempt), 10.0)
                if attempt + 1 < self.ner_retries:
                    time.sleep(min(delay, self.config.ner_retry_sleep_cap_s))
        rag_metrics.counter("ner_failed_parents_total").inc()
        return None
