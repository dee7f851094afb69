"""The RAG facade: one object for ingest and query, on one device.

The port of the JAX package's ``RAG`` (``facade.py``)::

    from triple_hybrid_rag_tpu_torch import RAG
    rag = RAG()                                 # device="cpu" for the CPU
    rag.ingest_text("Acme Corp pays invoices within 30 days.", name="terms.md")
    result = rag.query("When are invoices paid?")       # the staged path
    results = rag.query_batch(["When are invoices paid?"])  # the batched engine
    rag.save("./index")                         # checkpoint
    rag2 = RAG.load("./index")                  # restore, onto the card

The facade owns an :class:`~triple_hybrid_rag_tpu_torch.ingest.Ingestor` (the host
corpus and entity store) and rebuilds the
:class:`~triple_hybrid_rag_tpu_torch.retrieval.Retriever` whenever the corpus changed
since the last query. ``query`` runs the retriever's staged path, or with
``use_sharded_engine=True`` the batched
:class:`~triple_hybrid_rag_tpu_torch.engine.Engine`, which ``query_batch`` always
uses; the engine is kept through :meth:`Engine.refresh` while the shapes hold.
``rerank_fn(query, texts) -> scores`` reranks the staged path's candidates on the
host (the engine leaves it out, as the reference's does).

Checkpoints are the JAX package's format (``index/checkpoint.py``): either package
loads what the other saved.

External model servers: any ``*_api_base`` config field activates the matching
OpenAI-compatible HTTP client (``models/http_clients.wire_http_models``): the
embedder, the LLM planner and NER extractor (the latter only with ``ner_enabled``),
the reranker and the vision OCR; explicit arguments always win. ``ocr_fn(image,
mode)`` makes the loader an OCR processor's (``ocr.OCRProcessor``); without one the
ingestor builds the default OCR ladder (``ocr_glyph.get_default_ocr_fn``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

from .config import RAGConfig, get_settings
from .engine import Engine
from .ingest import Ingestor
from .retrieval import Retriever
from .types import IngestionResult, RetrievalResult

class RAG:
    def __init__(
        self,
        config: Optional[RAGConfig] = None,
        embedder=None,
        planner=None,
        extractor=None,
        rerank_fn=None,
        ocr_fn=None,
        use_sharded_engine: bool = False,
        device=None,
        cross_encoder=None,
    ) -> None:
        self.config = config or get_settings()
        # the on-device cross-encoder of rerank_backend="cross_encoder"
        # (models/cross_encoder.init_cross_encoder), handed to each retriever
        self._cross_encoder = cross_encoder

        # external model servers: any *_api_base field wires the matching HTTP
        # client; explicit arguments always win
        from .models.http_clients import wire_http_models

        wired = wire_http_models(self.config)
        embedder = embedder or wired.get("embedder")
        if extractor is None and "extractor_fn" in wired and self.config.ner_enabled:
            from .models.entity_extractor import CallableExtractor

            extractor = CallableExtractor(wired["extractor_fn"], self.config)
        if planner is None and "planner_fn" in wired:
            from .models.planner import CallablePlanner

            planner = CallablePlanner(wired["planner_fn"], self.config)
        self._planner = planner
        self._rerank_fn = rerank_fn or wired.get("rerank_fn")

        loader = None
        ocr_fn = ocr_fn or wired.get("ocr_fn")
        if ocr_fn is not None:
            from .loader import DocumentLoader
            from .ocr import OCRProcessor

            loader = DocumentLoader(ocr_processor=OCRProcessor(ocr_fn))

        self.ingestor = Ingestor(
            config=self.config, embedder=embedder, extractor=extractor, loader=loader,
            device=device,
        )
        self.device = self.ingestor.device
        self.use_sharded_engine = use_sharded_engine
        self._retriever: Optional[Retriever] = None
        self._engine: Optional[Engine] = None

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------

    def ingest(self, path: str | Path, **kwargs) -> IngestionResult:
        return self.ingestor.ingest_file(path, **kwargs)

    def ingest_directory(self, directory: str | Path, **kwargs) -> List[IngestionResult]:
        return self.ingestor.ingest_directory(directory, **kwargs)

    def ingest_text(self, text: str, name: str = "inline.txt", **kwargs) -> IngestionResult:
        return self.ingestor.ingest_text(text, name=name, **kwargs)

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    @property
    def retriever(self) -> Retriever:
        """The current snapshot's retriever, rebuilt when the corpus changed; the
        engine takes the new retriever through ``ShardedEngine.refresh``, or is
        rebuilt lazily when the shapes changed or placement failed."""
        if self._retriever is None or self.ingestor.corpus.dirty:
            kwargs = {}
            if self._planner is not None:
                kwargs["planner"] = self._planner
            if self._rerank_fn is not None:
                kwargs["rerank_llm_fn"] = self._rerank_fn
            if self._cross_encoder is not None:
                kwargs["cross_encoder"] = self._cross_encoder
            self._retriever = self.ingestor.make_retriever(**kwargs)
            if self._engine is not None and not self._engine.refresh(self._retriever):
                self._engine = None
        return self._retriever

    def query(self, query: str, top_k: Optional[int] = None, **kwargs) -> RetrievalResult:
        retriever = self.retriever
        if self.use_sharded_engine:
            return self._get_engine().retrieve(
                query, top_k=top_k, collection=kwargs.get("collection")
            )
        return retriever.retrieve(query, top_k=top_k, **kwargs)

    def query_batch(
        self,
        queries: List[str],
        top_k: Optional[int] = None,
        collection: Optional[str] = None,
        collections: Optional[List[Optional[str]]] = None,
    ) -> List[RetrievalResult]:
        """Batched retrieval through the engine (the serving path). Collection
        scoping works batch-wide or per query."""
        if not queries:
            return []
        return self._get_engine().retrieve_batch(
            queries, top_k=top_k, collection=collection, collections=collections
        )

    def _get_engine(self) -> Engine:
        """The serving engine: over every visible card when the RAG is on the default
        CUDA device (the reference's ``ShardedEngine(retriever, corpus_mesh())``),
        else over the one device it names (``"cpu"``, ``"cuda:1"``)."""
        retriever = self.retriever  # may drop self._engine via the rebuild
        if self._engine is None:
            from .parallel.mesh import default_mesh

            self._engine = Engine.from_retriever(retriever, mesh=default_mesh(retriever.device))
        return self._engine

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save(self, directory: str | Path) -> Path:
        from .index.checkpoint import save_ingestor

        return save_ingestor(self.ingestor, directory)

    @classmethod
    def load(
        cls, directory: str | Path, config: Optional[RAGConfig] = None,
        allow_pickle: bool = False, trust_config: bool = False, device=None, **kwargs
    ) -> "RAG":
        """Restore from a checkpoint onto ``device`` (the card unless the caller asks
        for the CPU). ``config`` replaces the saved one (a migration: the indexes are
        derived again from the stored full-dimension embeddings); ``allow_pickle``
        opts into loading legacy v1 (pickle) checkpoints; ``trust_config`` keeps the
        checkpoint's network fields (*_api_base / api_key) instead of stripping them
        — both only for checkpoints YOU wrote. ``kwargs`` go to :class:`RAG`.

        The restored stores go into the ingestor the new RAG builds, on its device
        and with its embedder, so the encoder is loaded once."""
        from .index.checkpoint import load_checkpoint
        from .models.entity_extractor import EntityStore

        corpus, entity_store, embeddings, saved = load_checkpoint(
            directory, allow_pickle=allow_pickle, trust_config=trust_config
        )
        rag = cls(config=config or saved, device=device, **kwargs)
        ing = rag.ingestor
        ing.corpus = corpus
        ing.entity_store = entity_store or EntityStore()
        ing.embeddings = embeddings
        return rag

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        out = {
            **self.ingestor.corpus.stats(),
            **{f"graph_{k}": v for k, v in self.ingestor.entity_store.stats().items()},
        }
        if self._engine is not None:  # the serving engine's backend choices
            st = self._engine.state
            out["engine_lexical_mode"] = st.lexical_mode
            out["engine_graph_mode"] = st.graph_mode
            out["engine_semantic_backend"] = "ivf" if st.ivf_mode else "exact"
            out["engine_n_shards"] = self._engine.n_shards
            out["engine_n_pad"] = st.n_pad
        return out
