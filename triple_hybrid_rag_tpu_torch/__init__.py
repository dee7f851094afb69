"""PyTorch/CUDA port of triple_hybrid_rag_tpu: ingestion and the batched
three-channel query program.

The JAX package stays the reference; this package imports nothing of it. Entry
points run on a CUDA device unless the caller passes ``device="cpu"``, where every
kernel's plain PyTorch version runs instead.
"""

from .config import RAGConfig, get_settings, reset_settings
from .engine import Engine
from .facade import RAG
from .index.state import IndexState

__all__ = ["Engine", "IndexState", "RAG", "RAGConfig", "get_settings", "reset_settings"]
