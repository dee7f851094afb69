"""PyTorch/CUDA port of triple_hybrid_rag_tpu: ingestion and the batched
three-channel query program.

The JAX package stays the reference; this package imports nothing of it. Entry
points run on a CUDA device unless the caller passes ``device="cpu"``, where every
kernel's plain PyTorch version runs instead.

The names are the reference's (its ``__init__.py``): the analyzer, the chunker, the
config, the ``types`` records and ``__version__`` load with the package; ``RAG``,
``Retriever`` and ``Ingestor`` (and the port's ``Engine`` and ``IndexState``) load
on first access, so importing the package does not build the device side.
"""

from .analyzer import Analyzer, Vocabulary, trigram_similarity
from .chunker import HierarchicalChunker, RecursiveSplitter
from .config import RAGConfig, get_settings, reset_settings
from .types import (
    ChildChunk,
    Document,
    Entity,
    EntityMention,
    EntityType,
    ExtractionResult,
    FileType,
    IngestionResult,
    IngestionStatus,
    LoadedDocument,
    Modality,
    OCRResult,
    PageContent,
    ParentChunk,
    QueryPlan,
    Relation,
    RelationType,
    RetrievalResult,
    SearchChannel,
    SearchResult,
    content_hash,
    file_hash_bytes,
)

__version__ = "0.1.0"

# name -> module of the names loaded on first access (PEP 562)
_LAZY = {
    "RAG": "facade",
    "Retriever": "retrieval",
    "Ingestor": "ingest",
    "Engine": "engine",
    "IndexState": "index.state",
}

__all__ = [
    "RAGConfig",
    "get_settings",
    "reset_settings",
    "Analyzer",
    "Vocabulary",
    "trigram_similarity",
    "HierarchicalChunker",
    "RecursiveSplitter",
    "Document",
    "PageContent",
    "LoadedDocument",
    "ParentChunk",
    "ChildChunk",
    "Entity",
    "EntityMention",
    "Relation",
    "ExtractionResult",
    "SearchResult",
    "QueryPlan",
    "RetrievalResult",
    "OCRResult",
    "IngestionResult",
    "FileType",
    "Modality",
    "EntityType",
    "RelationType",
    "IngestionStatus",
    "SearchChannel",
    "content_hash",
    "file_hash_bytes",
    "__version__",
    *_LAZY,
]


def __dir__():
    return sorted(set(list(globals()) + __all__))


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
