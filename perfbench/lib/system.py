"""The system under test: the PyTorch/CUDA port's index, engine and staged retriever,
built over the benchmark's inputs.

This is the one module of the harness that imports the program
(``triple_hybrid_rag_tpu_torch``), and only what an ingest would call: the
configuration, the placement (``IndexState.from_tensors``), the row quantizers
where the configuration stores int8 or int4, the corpus view that decodes
results, the two entries a window drives (``Engine`` and ``Retriever``), and the
``rag_metrics`` registry that the traced window's counters are read from.
Everything the program derives from the inputs (quantized rows and their scales,
the placed postings and graph tables, query plans and vectors) is made here by
the program.

The configuration's models are plug-ins (``lib/cell.py`` finds them by name): the
program side of each places the arrays its model reads (``place``), and the
embedder's builds the object both entries are handed (``build``), through the
program's public entries. Neither entry takes a reranker object, so the program
builds its reranker from ``rerank_backend`` over what was placed. So a new
configuration, with its models, is new files and new entries: nothing here names
a model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from .cell import Model, models as find_models
from .generator import Corpus


def rag_config(config: dict, variant: Optional[dict] = None):
    """The program's ``RAGConfig`` of a configuration file's ``rag_config`` block,
    with ``variant``'s keys over it (the lower-precision control)."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig

    keys = dict(config["rag_config"])
    keys.update(variant or {})
    return RAGConfig(**keys)


@dataclass
class Inputs:
    """What a program-side model plug-in is given."""

    corpus: Corpus
    config: dict  # the configuration file, as loaded
    cfg: Any  # the program's RAGConfig, the variant applied
    seed: int  # the run's --seed
    variant: Optional[dict]  # the control's keys, or None
    device: torch.device


@dataclass
class System:
    """What a driver needs: the placed state, its configuration and the embedder
    plug-in's query embedder."""

    config: Any  # RAGConfig
    state: Any  # IndexState
    embedder: Any

    def engine(self):
        from triple_hybrid_rag_tpu_torch.engine import Engine

        return Engine(self.state, config=self.config, embedder=self.embedder,
                      device=self.state.device)

    def retriever(self):
        from triple_hybrid_rag_tpu_torch.retrieval import Retriever

        return Retriever.from_state(self.state, embedder=self.embedder)


def build_system(corpus: Corpus, config: dict, device, variant: Optional[dict] = None,
                 seed: int = 0, models: Optional[Dict[str, Model]] = None) -> System:
    """Place ``corpus`` as the program's index under the configuration (and
    ``variant``), with the arrays of the configuration's ``models`` (default: the
    plug-ins its file names), and build its query embedder. Rows are
    quantized by the program's own quantizers where ``embedding_dtype`` asks for
    int8 or int4."""
    from triple_hybrid_rag_tpu_torch.analyzer import Vocabulary
    from triple_hybrid_rag_tpu_torch.corpus import SyntheticCorpusView
    from triple_hybrid_rag_tpu_torch.index.dense_index import quantize_rows_int4, quantize_rows_int8
    from triple_hybrid_rag_tpu_torch.index.state import IndexState
    from triple_hybrid_rag_tpu_torch.models.entity_extractor import canonical_key
    from triple_hybrid_rag_tpu_torch.types import Entity

    plugins = models if models is not None else find_models(config)
    cfg = rag_config(config, variant)
    inputs = Inputs(corpus, config, cfg, seed, variant, torch.device(device))
    dense = {"embeddings": corpus.rows, "valid": corpus.valid}
    if cfg.embedding_dtype in ("int8", "int4"):
        quantize = quantize_rows_int8 if cfg.embedding_dtype == "int8" else quantize_rows_int4
        dense["embeddings"], dense["dense_scales"] = quantize(corpus.rows)
    elif cfg.embedding_dtype != "bfloat16":
        raise ValueError(f"the benchmark's inputs serve bf16, int8 or int4 rows, not {cfg.embedding_dtype}")
    placed: Dict[str, Any] = {}
    for m in plugins.values():
        if hasattr(m.program, "place"):
            placed.update(m.program.place(inputs))
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
            **placed,
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
        inputs.device,
    )
    return System(cfg, state, plugins["embedder"].program.build(inputs, state))


def counters() -> Dict[str, float]:
    """Every counter series of the program's ``rag_metrics`` registry, by its
    exposition name (labels included), from the registry's Prometheus text."""
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics

    out: Dict[str, float] = {}
    kind = None
    for line in rag_metrics.prometheus_text().splitlines():
        if line.startswith("# TYPE "):
            kind = line.split()[3]
        elif line and kind == "counter":
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out
