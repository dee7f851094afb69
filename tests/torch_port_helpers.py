"""Shared helpers of the port's tests: carry a JAX ``Retriever`` over to the port.

Not a test module itself (no ``test_`` prefix); the ``tests/test_torch_*.py`` files
import it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from triple_hybrid_rag_tpu_torch.config import RAGConfig as TorchConfig
from triple_hybrid_rag_tpu_torch.corpus import CorpusView
from triple_hybrid_rag_tpu_torch.index.state import IndexState
from triple_hybrid_rag_tpu_torch.types import Entity as TorchEntity


def small_config():
    """The reference's config of ``tests/conftest.py``'s ``small_config`` fixture,
    for fixtures of a wider scope than a test."""
    from triple_hybrid_rag_tpu.config import RAGConfig

    return RAGConfig(
        lexical_top_k=8, semantic_top_k=8, graph_top_k=8, rerank_top_k=8, final_top_k=5,
        max_query_terms=8, doc_term_capacity=32, capacity_round=8, embedding_dim=32,
        embedding_dim_full=64, maxsim_dim=16, maxsim_doc_tokens=16, maxsim_query_tokens=8,
        graph_max_degree=8, graph_max_entities_per_chunk=8, embedder_backend="bowhash",
        ner_retry_sleep_cap_s=0.01,
    )


def torch_config(cfg) -> TorchConfig:
    """The port's config with every field of the reference's."""
    return TorchConfig(**dataclasses.asdict(cfg))


def flat_params(params) -> dict:
    """A flax parameter tree flattened as the packaged encoder npz names its arrays
    (``params/block_0/attn/query/kernel``, ...), for ``encoder_params_from_flax``."""
    import jax

    return {
        "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
        for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _record(obj) -> dict:
    d = dataclasses.asdict(obj)
    if "modality" in d:
        d["modality"] = getattr(obj.modality, "value", obj.modality)
    return d


def state_from_retriever(ret, config=None, device="cpu") -> IndexState:
    """IndexState.from_numpy over the JAX retriever's index arrays (as numpy)."""
    cfg = config or torch_config(ret.config)
    arrays = {"parent_of": np.asarray(ret.parent_of)}
    host = {
        "collection_ids": dict(ret.collection_ids),
        "corpus": CorpusView.from_records(
            [_record(c) for c in ret.corpus.children], [_record(p) for p in ret.corpus.parents]
        ),
    }
    arrays["collection_of"] = np.asarray(ret.collection_of)
    bm = ret.bm25_index
    if bm is not None:
        offs, lens, pd, _ = bm.host_csr
        arrays.update(
            bm25_offsets=np.asarray(offs), bm25_lengths=np.asarray(lens),
            bm25_postings_doc=np.asarray(pd), bm25_postings_weight=np.asarray(bm.host_weights),
            bm25_idf=np.asarray(bm.idf),
            bm25_term_ids=np.asarray(bm.term_ids), bm25_term_weights=np.asarray(bm.term_weights),
        )
        host["vocab"] = bm.vocab.to_list()
        host["n_rows"] = int(bm.term_ids.shape[0])
    dx = ret.dense_index
    if dx is not None:
        arrays.update(embeddings=np.asarray(dx.embeddings), valid=np.asarray(dx.valid))
        if dx.scales is not None:
            arrays["dense_scales"] = np.asarray(dx.scales)
    gx = ret.graph_index
    if gx is not None:
        arrays.update(nbr=np.asarray(gx.nbr), chunk_entities=np.asarray(gx.host_chunk_entities))
        host.update(
            entity_keys=list(gx.store.entities.keys()),
            entities=[
                TorchEntity(entity_id=e.entity_id, canonical_name=e.canonical_name, row=e.row)
                for e in gx.store.entities.values()
            ],
            row_of=dict(gx.row_of),
            seed_stop=gx.seed_stop,
        )
    mx = ret.maxsim_index
    if mx is not None:
        arrays.update(maxsim_tokens=np.asarray(mx.tokens), maxsim_mask=np.asarray(mx.mask))
    pe = getattr(ret.reranker, "parent_embeddings", None)
    if pe is not None:
        arrays["parent_emb"] = np.asarray(pe)
    return IndexState.from_numpy(arrays, host, cfg, device)
