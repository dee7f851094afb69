"""Graph index build: the entity store -> the device graph tables.

The port of the JAX package's ``build_graph_index`` (``index/graph_index.py``), so the
tables are equal: the undirected neighbour table ``nbr`` i32[E_pad, graph_max_degree]
(-1 padded, relations past the degree cap dropped), the chunk -> entity table
``chunk_entities`` i32[N_pad, graph_max_entities_per_chunk] in mention order, the
seed stoplist of entities mentioned in too many chunks, and ``row_of`` (entity id
-> row). The tables stay on the host: :meth:`IndexState.from_numpy
<triple_hybrid_rag_tpu_torch.index.state.IndexState.from_numpy>` places them with the
reference's graph-backend policy.

The staged retriever's graph channel (:func:`graph_search_plan`,
:func:`graph_search_seeds`, :func:`search_by_keywords_graph`, the ports of
``GraphIndex.search_plan`` / ``_search_seeds`` / ``search_by_keywords_graph``) reads
the placed :class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState`: its seed
lookup, neighbour table and ``chunk_entities``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RAGConfig
from ..corpus import CorpusStore
from ..models.entity_extractor import EntityStore
from ..ops.graph import khop_chunk_scores
from ..ops.topk import NEG_INF, masked_top_k
from ..types import Entity, QueryPlan


@dataclass
class GraphIndex:
    """The graph tables of one corpus snapshot, as host NumPy, and their store."""

    nbr: np.ndarray  # i32[E_pad, D] neighbour rows (-1 pad)
    chunk_entities: np.ndarray  # i32[N_pad, M] entity rows per child chunk (-1 pad)
    store: EntityStore
    row_of: Dict[str, int]  # entity_id -> row
    n_entities: int
    e_pad: int
    overflow_entities: int = 0  # entities whose degree exceeded graph_max_degree
    seed_stop: Optional[np.ndarray] = None  # bool[E_pad]: too ubiquitous to seed a query


def build_graph_index(
    store: EntityStore, corpus: CorpusStore, config: RAGConfig
) -> GraphIndex:
    """Assemble padded device tables from the triple store (one host pass)."""
    entities = list(store.entities.values())
    n_e = len(entities)
    e_pad = config.round_capacity(max(n_e, 1))
    row_of = {e.entity_id: i for i, e in enumerate(entities)}
    for e in entities:
        e.row = row_of[e.entity_id]

    # undirected adjacency (BFS semantics of `-[*1..h]-`), capped at graph_max_degree
    D = config.graph_max_degree
    host_adj: Dict[int, List[int]] = {}
    for rel in store.relations:
        a, b = row_of.get(rel.subject_id), row_of.get(rel.object_id)
        if a is None or b is None:
            continue
        host_adj.setdefault(a, [])
        host_adj.setdefault(b, [])
        if b not in host_adj[a]:
            host_adj[a].append(b)
        if a not in host_adj[b]:
            host_adj[b].append(a)
    nbr = np.full((e_pad, D), -1, np.int32)
    overflow = 0
    for row, ns in host_adj.items():
        if len(ns) > D:
            overflow += 1
        nbr[row, : min(len(ns), D)] = ns[:D]

    # chunk -> entities table over the child capacity
    M = config.graph_max_entities_per_chunk
    n_pad = config.round_capacity(max(len(corpus), 1))
    chunk_entities = np.full((n_pad, M), -1, np.int32)
    counts = np.zeros((n_pad,), np.int32)
    # distinct-chunk mention df per entity (mentions are deduped per
    # (entity, chunk) at store time) — feeds the seed stoplist
    ent_df = np.zeros((e_pad,), np.int64)
    for men in store.mentions:
        child = corpus.child(men.chunk_id)
        row = row_of.get(men.entity_id)
        if child is None or row is None or child.row < 0:
            continue
        ent_df[row] += 1
        c = counts[child.row]
        if c < M:
            chunk_entities[child.row, c] = row
            counts[child.row] = c + 1

    seed_stop = None
    if config.graph_seed_stop_df > 0:
        cut = max(
            float(config.graph_seed_stop_min),
            config.graph_seed_stop_df * max(len(corpus), 1),
        )
        seed_stop = ent_df > cut

    return GraphIndex(
        nbr=nbr,
        chunk_entities=chunk_entities,
        store=store,
        row_of=row_of,
        n_entities=n_e,
        e_pad=e_pad,
        overflow_entities=overflow,
        seed_stop=seed_stop,
    )


# ---------------------------------------------------------------- staged channel


def graph_search_plan(
    state, plan: QueryPlan, row_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The staged graph channel (the reference's ``GraphIndex.search_plan``): seeds
    from the plan's entities (three each), else from its keywords (two each)."""
    seeds: List[Entity] = []
    for name in plan.graph_entities:
        seeds.extend(state.seed_lookup(name, 3))
    if not seeds:
        for kw in plan.keywords:
            seeds.extend(state.seed_lookup(kw, 2))
    return graph_search_seeds(state, seeds, plan.graph_top_k, row_mask)


def search_by_keywords_graph(
    state, keywords: Sequence[str], top_k: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """keywords -> entity seeds (three each) -> k-hop -> chunks."""
    seeds: List[Entity] = []
    for kw in keywords:
        seeds.extend(state.seed_lookup(kw, 3))
    return graph_search_seeds(state, seeds, top_k)


def graph_search_seeds(
    state, seeds: Sequence[Entity], top_k: Optional[int],
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids i64[k], scores f32[k]) of the chunks best connected to ``seeds`` within
    ``graph_hops`` (the reference's ``GraphIndex._search_seeds``): the dense scan of
    ``chunk_entities``, scores <= 0 never surface; no seeds -> ids -1, scores -inf."""
    k = top_k or state.config.graph_top_k
    dev = state.device
    if not seeds:
        return (torch.full((k,), -1, dtype=torch.long, device=dev),
                torch.full((k,), NEG_INF, dtype=torch.float32, device=dev))
    vec = np.zeros((state.nbr.shape[0],), bool)
    for e in seeds:
        row = state.row_of.get(e.entity_id)
        if row is not None:
            vec[row] = True
    scores = khop_chunk_scores(
        state.nbr, state.chunk_entities, torch.from_numpy(vec).to(dev),
        hops=state.config.graph_hops,
    )
    return masked_top_k(scores, k, valid=row_mask)
