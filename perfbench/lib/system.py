"""The system under test: the PyTorch/CUDA port's index, engine and staged retriever,
built over the benchmark's inputs.

This is the one module of the harness that imports the program
(``triple_hybrid_rag_tpu_torch``), and only what an ingest would call: the
configuration, the placement (``IndexState.from_tensors``), the row and token
quantizers where the configuration stores int8 or int4, the BowHash query
embedder, the corpus view that decodes results, and the two entries a window
drives (``Engine`` and ``Retriever``). Everything the program derives from the
inputs (quantized rows and their scales, the int8 token store, the placed
postings and graph tables, query plans and vectors) is made here by the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .generator import Corpus


def rag_config(config: dict, variant: Optional[dict] = None):
    """The program's ``RAGConfig`` of a configuration file's ``rag_config`` block,
    with ``variant``'s keys over it (the lower-precision control)."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig

    keys = dict(config["rag_config"])
    keys.update(variant or {})
    return RAGConfig(**keys)


@dataclass
class System:
    """What a driver needs: the placed state, its configuration and embedder."""

    config: Any  # RAGConfig
    state: Any  # IndexState
    embedder: Any  # BowHashEmbedder

    def engine(self):
        from triple_hybrid_rag_tpu_torch.engine import Engine

        return Engine(self.state, config=self.config, embedder=self.embedder,
                      device=self.state.device)

    def retriever(self):
        from triple_hybrid_rag_tpu_torch.retrieval import Retriever

        return Retriever.from_state(self.state, embedder=self.embedder)


def build_system(corpus: Corpus, config: dict, device, variant: Optional[dict] = None) -> System:
    """Place ``corpus`` as the program's index under the configuration (and
    ``variant``). Rows and tokens are quantized by the program's own quantizers
    where ``embedding_dtype`` asks for int8 or int4 (the token store is int8
    under both, as the program stores it)."""
    from triple_hybrid_rag_tpu_torch.analyzer import Vocabulary
    from triple_hybrid_rag_tpu_torch.corpus import SyntheticCorpusView
    from triple_hybrid_rag_tpu_torch.index.dense_index import quantize_rows_int4, quantize_rows_int8
    from triple_hybrid_rag_tpu_torch.index.state import IndexState
    from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
    from triple_hybrid_rag_tpu_torch.models.entity_extractor import canonical_key
    from triple_hybrid_rag_tpu_torch.ops.maxsim import quantize_tokens
    from triple_hybrid_rag_tpu_torch.types import Entity

    cfg = rag_config(config, variant)
    dense = {"embeddings": corpus.rows, "valid": corpus.valid}
    tokens = corpus.tokens
    if cfg.embedding_dtype in ("int8", "int4"):
        quantize = quantize_rows_int8 if cfg.embedding_dtype == "int8" else quantize_rows_int4
        dense["embeddings"], dense["dense_scales"] = quantize(corpus.rows)
        tokens = quantize_tokens(corpus.tokens)
    elif cfg.embedding_dtype != "bfloat16":
        raise ValueError(f"the benchmark's inputs serve bf16, int8 or int4 rows, not {cfg.embedding_dtype}")
    names = corpus.entity_names()
    entities = [Entity(entity_id=f"e{i}", canonical_name=nm, row=i) for i, nm in enumerate(names)]
    state = IndexState.from_tensors(
        {
            "parent_of": corpus.parent_of,
            "bm25_offsets": corpus.offsets, "bm25_lengths": corpus.lengths,
            "bm25_postings_doc": corpus.postings_doc,
            "bm25_postings_weight": corpus.postings_weight,
            **dense,
            "nbr": corpus.nbr, "chunk_entities": corpus.chunk_entities,
            "maxsim_tokens": tokens, "maxsim_mask": corpus.tok_mask,
        },
        {
            "bm25_l_max": corpus.l_max,
            "stored_df": corpus.lengths.cpu().numpy(),
            "idf": corpus.idf.cpu().numpy(),
            "vocab": Vocabulary.from_list(corpus.vocab),
            "chunk_entities_host": corpus.chunk_entities.cpu().numpy(),
            "entity_keys": [canonical_key(nm) for nm in names],
            "entities": entities,
            "row_of": {e.entity_id: e.row for e in entities},
            "corpus": SyntheticCorpusView(corpus.n, corpus.text_of, corpus.children_per_parent),
        },
        cfg,
        torch.device(device),
    )
    embedder = BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)
    return System(cfg, state, embedder)
