"""Graph index build: the entity store -> the device graph tables.

The port of the JAX package's ``build_graph_index`` (``index/graph_index.py``), so the
tables are equal: the undirected neighbour table ``nbr`` i32[E_pad, graph_max_degree]
(-1 padded, relations past the degree cap dropped), the chunk -> entity table
``chunk_entities`` i32[N_pad, graph_max_entities_per_chunk] in mention order, the
seed stoplist of entities mentioned in too many chunks, and ``row_of`` (entity id
-> row). The tables stay on the host: :meth:`IndexState.from_numpy
<triple_hybrid_rag_tpu_torch.index.state.IndexState.from_numpy>` places them with the
reference's graph-backend policy.

The staged retriever's graph channel (:func:`graph_search_plan`, the port of
``GraphIndex.search_plan``) reads the placed
:class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState`: its seed lookup,
neighbour table and ``chunk_entities``.

:class:`GraphIndex` keeps the reference's lookup API (the agent tools'
``lookup_entity`` and the Cypher executor read it): :meth:`~GraphIndex.entity_lookup`,
:meth:`~GraphIndex.seed_lookup`, :meth:`~GraphIndex.related_entities` and
:meth:`~GraphIndex.relation_path` on the host tables, and
:meth:`~GraphIndex.entity_neighborhood`, :meth:`~GraphIndex.search_by_keywords_graph`
and :meth:`~GraphIndex.entity_distances`, which run k-hop on the device: over the tables the retriever placed (``placed``,
set when a :class:`~triple_hybrid_rag_tpu_torch.retrieval.Retriever` places the
index; no second copy), else over the host tables on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RAGConfig
from ..corpus import CorpusStore
from ..models.entity_extractor import EntityStore
from ..ops.graph import INF_DIST, khop_chunk_scores, khop_distances
from ..ops.topk import NEG_INF, masked_top_k
from ..types import Entity, QueryPlan


@dataclass
class GraphIndex:
    """The graph tables of one corpus snapshot, as host NumPy, their store, and the
    lookup / traversal API."""

    nbr: np.ndarray  # i32[E_pad, D] neighbour rows (-1 pad)
    chunk_entities: np.ndarray  # i32[N_pad, M] entity rows per child chunk (-1 pad)
    store: EntityStore
    row_of: Dict[str, int]  # entity_id -> row
    n_entities: int
    e_pad: int
    config: RAGConfig
    entity_rows: List[Entity] = field(default_factory=list)  # row -> entity
    host_adj: Dict[int, List[int]] = field(default_factory=dict)  # undirected, uncapped
    overflow_entities: int = 0  # entities whose degree exceeded graph_max_degree
    seed_stop: Optional[np.ndarray] = None  # bool[E_pad]: too ubiquitous to seed a query
    # the IndexState these tables were placed in (set by the Retriever): the device
    # lookups read its nbr / chunk_entities
    placed: Any = None

    # ------------------------------------------------------------------
    # lookup / traversal API
    # ------------------------------------------------------------------

    def entity_lookup(self, name: str) -> List[Entity]:
        return self.store.lookup(name, self.config.graph_fuzzy_threshold)

    def seed_lookup(self, name: str, limit: int = 3) -> List[Entity]:
        """entity_lookup minus the seed stoplist."""
        return seed_lookup(self.store, self.row_of, self.seed_stop, self.config, name, limit)

    def _tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(nbr, chunk_entities) on the device they were placed on, else the host
        tables as CPU tensors (views, not copies)."""
        st = self.placed
        if st is not None and st.nbr is not None and st.chunk_entities is not None:
            return st.nbr, st.chunk_entities
        return torch.from_numpy(self.nbr), torch.from_numpy(self.chunk_entities)

    def entity_neighborhood(
        self, entity_name: str, hops: Optional[int] = None, limit: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunks reachable from an entity: (chunk rows i64[limit], graph scores
        f32[limit]), -1 / -inf past the reachable ones."""
        hops = self.config.graph_hops if hops is None else hops
        limit = self.config.graph_top_k if limit is None else limit
        return self._khop_top_k(self.entity_lookup(entity_name)[:1], hops, limit)

    def _khop_top_k(
        self, seeds: Sequence[Entity], hops: int, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        nbr, chunk_entities = self._tables()
        return seeds_top_k(nbr, chunk_entities, self.row_of, seeds, hops, k)

    def related_entities(self, entity_name: str, limit: int = 20) -> List[Entity]:
        ents = self.entity_lookup(entity_name)
        if not ents:
            return []
        row = self.row_of.get(ents[0].entity_id)
        if row is None:
            return []
        return [self.entity_rows[n] for n in self.host_adj.get(row, [])[:limit]]

    def relation_path(
        self, name_a: str, name_b: str, max_hops: int = 4
    ) -> Optional[List[Entity]]:
        """Shortest entity path a..b (host BFS over the uncapped adjacency)."""
        ea, eb = self.entity_lookup(name_a), self.entity_lookup(name_b)
        if not ea or not eb:
            return None
        a = self.row_of.get(ea[0].entity_id)
        b = self.row_of.get(eb[0].entity_id)
        if a is None or b is None:
            return None
        if a == b:
            return [self.entity_rows[a]]
        prev: Dict[int, int] = {a: a}
        frontier = [a]
        for _ in range(max_hops):
            nxt = []
            for u in frontier:
                for v in self.host_adj.get(u, []):
                    if v not in prev:
                        prev[v] = u
                        nxt.append(v)
                        if v == b:
                            path = [v]
                            while path[-1] != a:
                                path.append(prev[path[-1]])
                            return [self.entity_rows[r] for r in reversed(path)]
            frontier = nxt
            if not frontier:
                break
        return None

    def search_by_keywords_graph(
        self, keywords: Sequence[str], top_k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """keywords -> entity seeds (three each) -> k-hop -> chunks."""
        seeds: List[Entity] = []
        for kw in keywords:
            seeds.extend(self.seed_lookup(kw, 3))
        return self._khop_top_k(seeds, self.config.graph_hops, top_k or self.config.graph_top_k)

    def execute_query(self, query: dict) -> dict:
        """Structured graph-query executor (the op a planner emits, or
        :func:`~triple_hybrid_rag_tpu_torch.index.cypher.translate_cypher` lowers
        Cypher to)::

            {"op": "neighborhood", "entity": str, "hops"?: int, "limit"?: int}
            {"op": "lookup",       "entity": str}
            {"op": "related",     "entity": str, "limit"?: int}
            {"op": "path",        "from": str, "to": str, "max_hops"?: int}
            {"op": "keywords",    "keywords": [str], "limit"?: int}

        Returns {"op", "nodes", "found" (path only), "chunk_rows", "chunk_scores"}."""
        op = str(query.get("op", ""))

        def nodes(ents):
            return [{"name": e.canonical_name, "type": e.entity_type.value} for e in ents]

        if op == "lookup":
            ents = self.entity_lookup(str(query.get("entity", "")))
            return {"op": op, "nodes": nodes(ents), "chunk_rows": [], "chunk_scores": []}
        if op == "related":
            ents = self.related_entities(
                str(query.get("entity", "")), int(query.get("limit", 20))
            )
            return {"op": op, "nodes": nodes(ents), "chunk_rows": [], "chunk_scores": []}
        if op == "path":
            path = self.relation_path(
                str(query.get("from", "")), str(query.get("to", "")),
                int(query.get("max_hops", 4)),
            )
            return {
                "op": op, "nodes": nodes(path or []), "found": path is not None,
                "chunk_rows": [], "chunk_scores": [],
            }
        if op in ("neighborhood", "keywords"):
            if op == "neighborhood":
                ids, scores = self.entity_neighborhood(
                    str(query.get("entity", "")),
                    hops=int(query.get("hops", self.config.graph_hops)),
                    limit=int(query.get("limit", self.config.graph_top_k)),
                )
            else:
                ids, scores = self.search_by_keywords_graph(
                    [str(k) for k in query.get("keywords", [])],
                    top_k=int(query.get("limit", self.config.graph_top_k)),
                )
            ids_np, scores_np = ids.cpu().numpy(), scores.cpu().numpy()
            keep = ids_np >= 0
            return {
                "op": op,
                "nodes": [],
                "chunk_rows": ids_np[keep].tolist(),
                "chunk_scores": scores_np[keep].tolist(),
            }
        raise ValueError(f"unknown graph op {op!r}")

    def execute_cypher(self, cypher: str, parameters: Optional[dict] = None) -> dict:
        """Execute Cypher text: lowered onto :meth:`execute_query` by
        :func:`~triple_hybrid_rag_tpu_torch.index.cypher.translate_cypher`, which
        raises ``CypherTranslationError`` outside its subset."""
        from .cypher import translate_cypher

        return self.execute_query(translate_cypher(cypher, parameters))

    def entity_distances(self, entity_name: str, hops: int = 2) -> Dict[str, float]:
        """Entity name -> hop distance from the named entity, for those within
        ``hops`` (k-hop on the device)."""
        ents = self.entity_lookup(entity_name)
        if not ents:
            return {}
        nbr, _ = self._tables()
        seeds = seed_mask(self.row_of, ents[:1], nbr.shape[0], nbr.device)
        dist = khop_distances(nbr, seeds, hops=hops).cpu().numpy()
        return {
            self.entity_rows[i].canonical_name: float(dist[i])
            for i in range(self.n_entities)
            if dist[i] < float(INF_DIST)
        }


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
        config=config,
        entity_rows=entities,
        host_adj=host_adj,
        overflow_entities=overflow,
        seed_stop=seed_stop,
    )


# ---------------------------------------------------------------- staged channel


def seed_lookup(
    store: EntityStore, row_of: Dict[str, int], seed_stop: Optional[np.ndarray],
    config: RAGConfig, name: str, limit: int = 3,
) -> List[Entity]:
    """Entity lookup minus the seed stoplist (stop entities never seed a query's
    expansion; filtering happens before the limit)."""
    out: List[Entity] = []
    for e in store.lookup(name, config.graph_fuzzy_threshold):
        row = row_of.get(e.entity_id)
        if row is not None and seed_stop is not None and bool(seed_stop[row]):
            continue
        out.append(e)
        if len(out) >= limit:
            break
    return out


def seed_mask(row_of: Dict[str, int], seeds: Sequence[Entity], e_pad: int, device) -> torch.Tensor:
    """bool[e_pad]: the rows of ``seeds``."""
    mask = np.zeros((e_pad,), bool)
    for e in seeds:
        row = row_of.get(e.entity_id)
        if row is not None:
            mask[row] = True
    return torch.from_numpy(mask).to(device)


def seeds_top_k(
    nbr: torch.Tensor, chunk_entities: torch.Tensor, row_of: Dict[str, int],
    seeds: Sequence[Entity], hops: int, k: int, row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids i64[k], scores f32[k]) of the chunks best connected to ``seeds`` within
    ``hops`` (the reference's ``GraphIndex._search_seeds``): the dense scan of
    ``chunk_entities``, scores <= 0 never surface; no seeds -> ids -1, scores -inf."""
    dev = nbr.device
    if not seeds:
        return (torch.full((k,), -1, dtype=torch.long, device=dev),
                torch.full((k,), NEG_INF, dtype=torch.float32, device=dev))
    scores = khop_chunk_scores(
        nbr, chunk_entities, seed_mask(row_of, seeds, nbr.shape[0], dev), hops=hops
    )
    return masked_top_k(scores, k, valid=row_mask)


def graph_search_plan(
    state, plan: QueryPlan, row_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The staged graph channel (the reference's ``GraphIndex.search_plan``) over the
    placed state: seeds from the plan's entities (three each), else from its
    keywords (two each)."""
    seeds: List[Entity] = []
    for name in plan.graph_entities:
        seeds.extend(state.seed_lookup(name, 3))
    if not seeds:
        for kw in plan.keywords:
            seeds.extend(state.seed_lookup(kw, 2))
    cfg = state.config
    return seeds_top_k(state.nbr, state.chunk_entities, state.row_of, seeds, cfg.graph_hops,
                       plan.graph_top_k or cfg.graph_top_k, row_mask)
