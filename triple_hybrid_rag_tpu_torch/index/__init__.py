"""Index structures derived from the corpus, their placed state, and the
query-side index helpers (the reference's ``index/__init__.py`` names)."""

from .bm25_index import BM25Index, build_bm25_index
from .dense_index import DenseIndex, build_dense_index
from .graph_index import GraphIndex, build_graph_index

__all__ = [
    "BM25Index",
    "build_bm25_index",
    "DenseIndex",
    "build_dense_index",
    "GraphIndex",
    "build_graph_index",
]
