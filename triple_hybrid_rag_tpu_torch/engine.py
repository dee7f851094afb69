"""The batched three-channel query program over a mesh of devices.

The port of the JAX ``ShardedEngine`` (``parallel/engine.py``). A batch of query
texts is prepared on the host (plan, analyze, embed, seed, scope) and then runs as
one program over the mesh (``parallel/mesh.py``; one device by default):

    per shard: BM25 top-k (sorted postings,  ->\\
                 or the term-table kernel)
    per shard: dense top-k (fused kernel)       -> gather, exact merge -> weighted RRF
    per shard: graph chunk top-k             ->/   -> parent expand -> MaxSim rerank
                                                      (kernel) or dot rerank -> safety gate

The index is laid out by ``parallel/placement.py``: each shard holds a contiguous
block of rows, and each data row of the mesh a whole replica. The batch splits into
contiguous slices, one per data row. Within a row the shards' top-k lists are
launched from this one thread in shard order (CUDA launches are asynchronous, so
separate cards overlap), their ids offset by ``shard * n_loc``, copied to the row's
first device and merged by the reference's exact ``merge_topk``; the k-hop entity
walk runs once per row there and its result is copied to the shards. Fusion,
expansion, rerank and gate run once per row, on that device. One process drives
every device; no process group is involved.

Program variants follow the reference's ``(batch, scoped, graph)`` keys: the
collection mask is only built for scoped batches, narrow batches take the sparse
graph path when the large-batch path is the dense scan, and narrow batches with no
graph-shaped query skip the graph channel. PyTorch runs eagerly, so a variant is a
branch of :meth:`Engine.run`, not a compiled program.

On a CUDA device the dense channel goes through the hand-written fused kernel when
``use_fused_topk`` is None or True (``ops/fused_topk.py``; bf16, f32, int8 and packed
int4 rows), the term-table lexical backend through the term-table kernel
(``ops/bm25.py``), and the MaxSim rerank through the MaxSim kernel (``ops/maxsim.py``).
With ``semantic_backend="ivf"`` the dense channel probes the blocked-IVF layout
instead (``index/ivf.py``) and launches no bucket maxima.

An embedder with ``encode_queries_device`` (the trained encoder) encodes a batch on
the device, and its outputs feed the program without a copy to the host
(``device_query_encode``, the reference's default); the hash embedders embed on
the host.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .analyzer import Analyzer
from .config import RAGConfig
from .device import resolve_device
from .index.dense_index import (
    dense_scores_batch,
    dense_scores_int8_batch,
    int4_topk_blocked,
    truncate_matryoshka,
    zero_query_guard,
)
from .index.ivf import ivf_topk_local
from .index.state import IndexState
from .models.embedder import get_default_embedder
from .models.planner import get_planner
from .observability.profiling import annotate
from .ops.bm25 import (
    score_postings_topk_pre,
    score_postings_topk_tiered,
    score_termtable_batch,
)
from .ops.fused_topk import fused_dense_topk
from .ops.fusion import (
    FusedCandidates,
    apply_safety_denoise,
    conformal_denoise_mask,
    fuse_rrf,
    minmax_normalize,
)
from .ops.graph import graph_sparse_topk, graph_topk_batch, khop_distances, seed_vectors
from .ops.maxsim import calibrate_maxsim, maxsim_scores
from .ops.topk import bucketed_masked_top_k_batch, lax_top_k, masked_top_k, merge_topk
from .parallel.mesh import DeviceMesh, single_device_mesh
from .parallel.placement import place
from .retrieval import decode_results, maxsim_query_weights
from .types import QueryPlan, RetrievalResult

# term-table scores held at once, in elements: the f32[Bq, n_pad] block of one kernel call
_TERMTABLE_SCORE_ELEMS = 1 << 27


def _same(a: Optional[torch.Tensor], b: Optional[torch.Tensor], key) -> bool:
    """Both absent, or both present with equal ``key``."""
    if a is None or b is None:
        return a is None and b is None
    return key(a) == key(b)


class QueryArgs(NamedTuple):
    """One prepared batch on the device (the reference's query wire format: query
    vectors and tokens rounded to float16 on the host)."""

    q_terms: torch.Tensor  # i32[B, Q]
    qs_terms: torch.Tensor  # i32[B, Q] small-tier terms
    qs_slots: torch.Tensor
    ql_terms: torch.Tensor  # i32[B, Ql] large-tier terms
    ql_slots: torch.Tensor
    q_vec: torch.Tensor  # f16[B, D]
    q_tokens: torch.Tensor  # f16[B, Tq, Dm]
    q_tok_mask: torch.Tensor  # f16[B, Tq] MaxSim token weights
    seed_rows: torch.Tensor  # i32[B, S]
    weights: torch.Tensor  # f32[B, 4]: channel RRF weights + ordering blend
    threshold: torch.Tensor  # f32[]
    alpha: torch.Tensor  # f32[]
    graph_on: torch.Tensor  # bool[B]
    coll_cid: torch.Tensor  # i32[B]: -1 unscoped, -2 match nothing


class Engine:
    """Placed index + the batched query program for one corpus snapshot."""

    def __init__(
        self,
        state: IndexState,
        config: Optional[RAGConfig] = None,
        embedder=None,
        planner=None,
        device=None,
        dot_rerank: bool = True,
        mesh: Optional[DeviceMesh] = None,
    ) -> None:
        # with a mesh and no device, the queries are prepared where the state lies
        self.device = resolve_device(state.device if device is None and mesh is not None else device)
        cfg = config or state.config
        self.config = cfg
        if cfg.rerank_enabled and cfg.rerank_backend == "cross_encoder":
            raise NotImplementedError(
                "the batched Engine has no cross-encoder rerank: serve rerank_backend="
                "'cross_encoder' through the staged path (RAG.query, Retriever.retrieve)"
            )
        if self.device != state.device:
            raise ValueError(f"index state lives on {state.device}, engine on {self.device}")
        # config.mesh_shape is only carried, as in the reference: the mesh decides
        self.mesh = mesh if mesh is not None else single_device_mesh(state.parent_of.device)
        self.state = state
        self.placement = place(state, self.mesh)
        self.corpus = state.corpus
        self.analyzer = Analyzer(cfg)
        self.embedder = embedder or get_default_embedder(cfg, device=self.device)
        self.planner = planner or get_planner(cfg)
        # the anchored encoder's MaxSim renormalization, fixed for the engine's life
        # (parallel/engine.py:549); 1.0 for the hash embedders
        self.maxsim_calibration = float(getattr(self.embedder, "maxsim_calibration", 1.0))
        # encode query batches on the device when the embedder can (False: the
        # host path, embed_texts + token_embeddings)
        self.device_query_encode = True
        # without a MaxSim store, rerank by the parents' mean embeddings; the
        # reference's engine does so only when its retriever's reranker holds them
        # (not under a host rerank_fn: parallel/engine.py:430)
        self.dot_rerank = dot_rerank

    @classmethod
    def from_retriever(cls, retriever, mesh: Optional[DeviceMesh] = None) -> "Engine":
        """The engine over a :class:`~triple_hybrid_rag_tpu_torch.retrieval.Retriever`'s
        placed state, with its embedder and planner, over ``mesh`` (default: the
        retriever's device alone). It reranks by the parents' mean embeddings where
        the retriever's reranker holds them (``parallel.ShardedEngine``)."""
        from .parallel.engine import ShardedEngine

        return ShardedEngine(
            retriever, mesh if mesh is not None else single_device_mesh(retriever.device)
        )

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["shard"]

    def refresh(self, state: IndexState) -> bool:
        """Swap in an updated index state when every static statistic the program
        depends on is unchanged (capacity, windows, graph mode and entity capacity,
        dims and row dtype, the IVF mode, config, which fixes the IVF block width),
        over this engine's mesh as well (the capacity rounded to it, the largest
        per-shard postings and mention blocks); the new state brings its own arrays,
        the IVF layout included, and is placed over the mesh anew. Returns False
        when the shapes changed; build a new Engine then."""
        old = self.state
        # capacity and windows are compared as placed over the mesh, below
        same = (
            state.lexical_mode == old.lexical_mode
            and state.graph_mode == old.graph_mode
            and state.graph_small_sparse == old.graph_small_sparse
            and state.graph_active == old.graph_active
            and state.graph_m == old.graph_m
            and state.dim == old.dim
            and state.ivf_mode == old.ivf_mode
            and state.config == old.config
            and state.device == old.device
            and _same(state.embeddings, old.embeddings, lambda t: t.dtype)
            and _same(state.nbr, old.nbr, lambda t: t.shape[0])
            and _same(state.maxsim_tokens, old.maxsim_tokens, lambda t: t.shape)
            and _same(state.parent_emb, old.parent_emb, lambda t: t.shape)
        )
        if not same:
            return False
        placement = place(state, self.mesh)
        if placement.statics() != self.placement.statics():
            return False
        self.state, self.placement, self.corpus = state, placement, state.corpus
        return True

    # ------------------------------------------------------------------ host prep

    def prepare_queries(
        self, queries: Sequence[str], collections: Optional[Sequence[Optional[str]]] = None
    ) -> Tuple[List[QueryPlan], QueryArgs]:
        """Host prep for a batch: plan, analyze, embed, seed, collection scope.

        While a profiler records, the prep is the range ``engine.prep``, holding
        ``engine.plan``, ``engine.terms``, ``engine.encode``, ``engine.seeds`` and
        ``engine.upload`` (the copies to the device). With ``device_query_encode``
        and an embedder that has ``encode_queries_device``, the query vectors and
        tokens are made on the device and stay there; a failure there surfaces in
        :meth:`retrieve_batch`, which retries once through the host path."""
        with annotate("engine.prep"):
            return self._prepare(queries, collections)

    def _prepare(self, queries, collections):
        st = self.state
        cfg = self.config
        b = len(queries)
        with annotate("engine.plan"):
            plans = [self.planner.plan(q) for q in queries]

        coll_cid = np.full((b,), -1, np.int32)
        if collections is not None:
            for i, name in enumerate(collections):
                if name is not None:
                    coll_cid[i] = st.collection_ids.get(name, -2)

        q_terms = np.full((b, cfg.max_query_terms), -1, np.int32)
        qs_terms = np.full((b, cfg.max_query_terms), -1, np.int32)
        qs_slots = np.zeros((b, cfg.max_query_terms), np.int32)
        ql_terms = np.full((b, cfg.bm25_large_slots), -1, np.int32)
        ql_slots = np.zeros((b, cfg.bm25_large_slots), np.int32)
        if st.vocab is not None:
            with annotate("engine.terms"):
                for i, plan in enumerate(plans):
                    q_terms[i] = st.encode_query(plan.keywords)
                    if cfg.lexical_tiering and st.lexical_mode == "sorted":
                        qs_terms[i], qs_slots[i], ql_terms[i], ql_slots[i] = (
                            st.encode_query_tiered(plan.keywords)
                        )

        sem_texts = [p.semantic_query_text or p.original_query for p in plans]
        with annotate("engine.encode"):
            q_vec, q_tokens, q_tok_mask = self._encode(sem_texts)

        seed_rows = np.full((b, cfg.graph_max_seeds), -1, np.int32)
        graph_on = np.zeros((b,), bool)
        if st.has_graph:
            with annotate("engine.seeds"):
                for i, plan in enumerate(plans):
                    if not plan.requires_graph:
                        continue
                    n_seeds = 0
                    for name in plan.graph_entities or plan.keywords:
                        for e in st.seed_lookup(name, 3):
                            row = st.row_of.get(e.entity_id)
                            if row is not None and n_seeds < cfg.graph_max_seeds:
                                seed_rows[i, n_seeds] = row
                                n_seeds += 1
                                graph_on[i] = True
                        if n_seeds >= cfg.graph_max_seeds:
                            break

        with annotate("engine.upload"):
            weights = np.asarray(
                [
                    [
                        p.weights.get("lexical", cfg.lexical_weight),
                        p.weights.get("semantic", cfg.semantic_weight),
                        p.weights.get("graph", cfg.graph_weight),
                        cfg.rerank_blend_rrf_relational
                        if p.requires_graph and p.intent in ("relational", "entity_lookup")
                        else cfg.rerank_blend_rrf,
                    ]
                    for p in plans
                ],
                np.float32,
            ).reshape(b, 4)

            dev = self.device

            def to_dev(x):  # numpy from the host, or a tensor the device encode made
                x = x if torch.is_tensor(x) else torch.from_numpy(x)
                return x.to(dev, non_blocking=True)

            args = QueryArgs(
                *(to_dev(x) for x in (
                    q_terms, qs_terms, qs_slots, ql_terms, ql_slots, q_vec, q_tokens,
                    q_tok_mask, seed_rows, weights,
                )),
                threshold=torch.tensor(
                    cfg.safety_threshold if cfg.safety_enabled else -1e9, dtype=torch.float32,
                    device=dev,
                ),
                alpha=torch.tensor(
                    cfg.denoise_alpha if cfg.denoise_enabled else 0.0, dtype=torch.float32,
                    device=dev,
                ),
                graph_on=torch.from_numpy(graph_on).to(dev),
                coll_cid=torch.from_numpy(coll_cid).to(dev),
            )
        return plans, args

    def _encode(self, sem_texts: Sequence[str]):
        """(q_vec f16[B, D], q_tokens f16[B, Tq, Dm], q_tok_mask f16[B, Tq]) of the
        semantic texts: tensors on the device from the device encode, else numpy
        (the reference's f16 query wire either way)."""
        st, cfg = self.state, self.config
        b = len(sem_texts)
        q_vec = q_tokens = q_tok_mask = None
        encode = getattr(self.embedder, "encode_queries_device", None)
        if self.device_query_encode and st.has_dense and encode is not None:
            t_q = cfg.maxsim_query_tokens if st.maxsim_tokens is not None else 1
            q_vec, tok, occupied = encode(
                sem_texts, out_dim=cfg.embedding_dim, max_tokens=t_q, token_dim=cfg.maxsim_dim
            )
            if st.maxsim_tokens is not None:
                q_tokens, q_tok_mask = tok, self._token_weights(occupied, sem_texts)
        if q_vec is None:
            with annotate("engine.encode.vectors"):
                q_vec_f32 = np.zeros((b, st.dim), np.float32)
                if st.has_dense:
                    # one batched embed call; a failed embed yields zero vectors, which
                    # the program's zero-vector guard turns into an empty dense channel
                    try:
                        raw = np.asarray(self.embedder.embed_texts(sem_texts), np.float32)
                    except Exception:
                        raw = np.zeros((b, self.embedder.dim), np.float32)
                    q_vec_f32 = truncate_matryoshka(raw, cfg.embedding_dim)
                q_vec = q_vec_f32.astype(np.float16)
        if q_tokens is None and st.maxsim_tokens is not None:
            with annotate("engine.encode.tokens"):
                q_tokens_f32 = self.embedder.token_embeddings(
                    sem_texts, max_tokens=cfg.maxsim_query_tokens, dim=cfg.maxsim_dim
                )
                q_tokens = q_tokens_f32.astype(np.float16)
            q_tok_mask = self._token_weights(np.any(q_tokens_f32 != 0, axis=-1), sem_texts)
        elif q_tokens is None:
            q_tokens = np.zeros((b, 1, 1), np.float16)
            q_tok_mask = np.zeros((b, 1), np.float16)
        return q_vec, q_tokens, q_tok_mask

    def _token_weights(self, occupied: np.ndarray, sem_texts: Sequence[str]) -> np.ndarray:
        """f16[B, T] MaxSim query-token weights: the occupied slots, with function
        words down-weighted (``maxsim_query_weights``)."""
        with annotate("engine.encode.weights"):
            w = occupied.astype(np.float16)
            for i, t in enumerate(sem_texts):
                w[i] *= maxsim_query_weights(t, self.analyzer, w.shape[1]).astype(np.float16)
        return w

    # ------------------------------------------------------------------ device program

    def use_fused(self) -> bool:
        """Dense channel through the fused kernel: ``use_fused_topk`` None resolves
        to the kernel on a CUDA mesh, for every row dtype (the reference's TPU auto
        rule, and its exception for int4 rows, do not apply)."""
        flag = self.config.use_fused_topk
        return self.mesh.grid[0][0].type == "cuda" if flag is None else bool(flag)

    @torch.no_grad()
    def run(self, args: QueryArgs, scoped: bool = False, graph: bool = True):
        """The batched program. Returns (ids i64[B, final_k], scores f32[B, final_k],
        refused bool[B], max_score f32[B], FusedCandidates [B, rerank_k], rerank
        f32[B, rerank_k]) on the engine's device. The batch splits into one
        contiguous slice per data row of the mesh (B must be a multiple of the
        rows). Each stage runs under a profiler range (``engine.lexical``,
        ``engine.dense``, ``engine.graph``, ``engine.tail``)."""
        dp = self.mesh.shape["data"]
        outs = []
        for r in range(dp):
            a = self.row_args(args, r)
            with annotate("engine.lexical"):
                lex = self._lexical(a, scoped, r)
            with annotate("engine.dense"):
                sem = self._dense(a, scoped, r)
            with annotate("engine.graph"):
                gr = self._graph(a, scoped, graph, r)
            with annotate("engine.tail"):
                outs.append(self._tail(a, lex, sem, gr, r))
        if dp == 1:
            ids, scores, refused, max_score, fused, rerank = outs[0]
            fused = FusedCandidates(*(x.to(self.device) for x in fused))
            return (*(x.to(self.device) for x in (ids, scores, refused, max_score)), fused,
                    rerank.to(self.device))

        def cat(xs):
            return torch.cat([x.to(self.device) for x in xs], 0)

        ids, scores, refused, max_score, fused, rerank = zip(*outs)
        return (cat(ids), cat(scores), cat(refused), cat(max_score),
                FusedCandidates(*(cat(f) for f in zip(*fused))), cat(rerank))

    def row_args(self, args: QueryArgs, row: int) -> QueryArgs:
        """Data row ``row``'s contiguous slice of a prepared batch, on the row's
        device. The batch must be a multiple of the mesh's data rows."""
        dp = self.mesh.shape["data"]
        batch = args.q_vec.shape[0]
        if batch % dp:
            raise ValueError(f"batch {batch} must divide the data axis ({dp})")
        per = batch // dp
        dev = self.placement.rows[row].device
        return QueryArgs(*(
            (x if x.dim() == 0 else x[row * per:(row + 1) * per]).to(dev) for x in args
        ))

    def _shards(self, args: QueryArgs, scoped: bool, row: int):
        """(shard state, the query args on its device, its row mask bool[B, n_loc]
        or None) for each shard of data row ``row``."""
        out = []
        for st in self.placement.shards[row]:
            a = QueryArgs(*(x.to(st.device) for x in args))
            mask = None
            if scoped:
                cid = a.coll_cid
                mask = (cid[:, None] == -1) | (st.collection_of[None, :] == cid[:, None])
            out.append((st, a, mask))
        return out

    def _empty(self, batch: int, row: int = 0):
        dev = self.placement.rows[row].device
        return (
            torch.full((batch, 1), -1, dtype=torch.long, device=dev),
            torch.zeros((batch, 1), dtype=torch.float32, device=dev),
        )

    def _merge(self, parts, k: int, row: int):
        """The reference's exact merge of the shards' [B, k_local] lists: local ids
        offset by ``shard * n_loc`` (-1 stays), gathered to the row's device as
        [B, S, k_local], one ``merge_topk``."""
        dev = self.placement.rows[row].device
        n_loc = self.placement.n_loc
        ids = [i if si == 0 else torch.where(i >= 0, i + si * n_loc, i)
               for si, (i, _) in enumerate(parts)]
        ids = torch.stack([i.to(dev) for i in ids], 1)
        vals = torch.stack([v.to(dev) for _, v in parts], 1)
        return merge_topk(ids, vals, k)

    def _lexical(self, args: QueryArgs, scoped: bool = False, row: int = 0):
        """The lexical channel of data row ``row`` (``args`` that row's slice, on its
        device): each shard's top-k over its rows, merged."""
        cfg = self.config
        state = self.state
        if state.lexical_mode == "none" or not cfg.lexical_enabled:
            return self._empty(args.q_vec.shape[0], row)
        parts = []
        for st, a, mask in self._shards(args, scoped, row):
            if st.lexical_mode == "termtable":
                # one pass of the table per block of queries, then the top-k of the block
                batch = a.q_terms.shape[0]
                step = max(1, _TERMTABLE_SCORE_ELEMS // st.n_pad)
                found = []
                for lo in range(0, batch, step):
                    scores = score_termtable_batch(
                        st.term_ids, st.term_weights, a.q_terms[lo:lo + step]
                    )
                    m = None if mask is None else mask[lo:lo + step]
                    found.append(masked_top_k(scores, cfg.lexical_top_k, valid=m))
                parts.append(tuple(torch.cat(x, 0) for x in zip(*found)))
                continue
            csr = (st.lex_offsets, st.lex_lengths, st.lex_pd, st.lex_pt)
            if cfg.lexical_tiering:
                parts.append(score_postings_topk_tiered(
                    *csr, a.qs_terms, a.qs_slots, a.ql_terms, a.ql_slots, mask,
                    l_small=min(cfg.bm25_small_window, st.lex_l_max), l_max=st.lex_l_max,
                    n_pad=st.n_pad, top_k=cfg.lexical_top_k,
                ))
            else:
                parts.append(score_postings_topk_pre(
                    *csr, a.q_terms, mask, l_max=st.lex_l_max, n_pad=st.n_pad,
                    top_k=cfg.lexical_top_k,
                ))
        return self._merge(parts, cfg.lexical_top_k, row)

    def _dense(self, args: QueryArgs, scoped: bool = False, row: int = 0):
        """The dense channel of data row ``row``: each shard's top-k, merged, then
        the zero-vector guard."""
        cfg = self.config
        q_vec = args.q_vec.float()
        if not (self.state.has_dense and cfg.semantic_enabled):
            return self._empty(q_vec.shape[0], row)
        k = cfg.semantic_top_k
        parts = []
        for st, a, mask in self._shards(args, scoped, row):
            q = a.q_vec.float()
            scope = dict(
                collection_of=st.collection_of if scoped else None,
                coll_cid=a.coll_cid if scoped else None,
            )
            if st.ivf_mode:
                # blocked IVF: probe the top block centroids, score their rows; ids
                # come back as local rows, so the merge and the guard apply unchanged
                quantized = st.embeddings.dtype in (torch.int8, torch.uint8)
                parts.append(ivf_topk_local(
                    st.embeddings, st.dense_scales if quantized else None, st.ivf_perm,
                    st.ivf_centroids, q, probes=cfg.ivf_probes, top_k=k, row_mask=mask,
                ))
            elif self.use_fused():  # every row dtype
                parts.append(fused_dense_topk(
                    st.embeddings, st.valid, q, k, scales=st.dense_scales, **scope
                ))
            elif st.embeddings.dtype == torch.uint8:  # packed int4: blocked unpack
                parts.append(int4_topk_blocked(
                    st.embeddings, st.dense_scales, st.valid, q, k, **scope
                ))
            else:
                if st.embeddings.dtype == torch.int8:
                    scores = dense_scores_int8_batch(st.embeddings, st.dense_scales, q)
                else:
                    scores = dense_scores_batch(st.embeddings, q)
                valid = st.valid[None, :] if mask is None else st.valid[None, :] & mask
                parts.append(bucketed_masked_top_k_batch(
                    scores, k, valid=valid, invalid_score_floor=-2.0
                ))
        ids, vals = self._merge(parts, k, row)
        return zero_query_guard(q_vec, ids, vals)

    def _graph(self, args: QueryArgs, scoped: bool = False, graph: bool = True, row: int = 0):
        """The graph channel of data row ``row``: the k-hop walk once on the row's
        device, then each shard's chunk top-k (the sparse mention walk or the dense
        scan), merged."""
        cfg = self.config
        rs = self.placement.rows[row]
        batch = args.q_vec.shape[0]
        if not (rs.has_graph and cfg.graph_enabled and graph):
            return self._empty(batch, row)
        hops = cfg.graph_hops
        mode = rs.graph_mode
        if mode == "dense" and rs.graph_small_sparse and batch <= cfg.graph_sparse_max_batch:
            mode = "sparse"  # narrow batches: the per-query mention walk
        dist = khop_distances(rs.nbr, seed_vectors(args.seed_rows, rs.nbr.shape[0]), hops=hops)
        reach = dist <= float(hops)
        ent_all = torch.where(reach, 1.0 / (1.0 + dist), torch.zeros_like(dist))
        graph_on = args.graph_on
        if mode == "sparse":
            act_s, act_e = lax_top_k(
                torch.where(graph_on[:, None], ent_all, torch.zeros_like(ent_all)), rs.graph_active
            )
            act_e = torch.where(act_s > 0.0, act_e, torch.full_like(act_e, -1))
        else:
            # u8 hop ranks order the buckets exactly as the f32 scores do
            ranks = torch.where(
                reach & graph_on[:, None], (float(hops) + 1.0) - dist, torch.zeros_like(dist)
            ).to(torch.uint8)
        parts = []
        for st, a, mask in self._shards(args, scoped, row):
            if mode == "sparse":
                parts.append(graph_sparse_topk(
                    st.g_offsets, st.g_lengths, st.g_docs, act_e.to(st.device),
                    act_s.to(st.device), mask, l_max_g=st.g_l_max, n_pad=st.n_pad,
                    top_k=cfg.graph_top_k, run_bound=st.graph_m,
                ))
            else:
                parts.append(graph_topk_batch(
                    st.chunk_entities, ent_all.to(st.device), cfg.graph_top_k, valid=mask,
                    query_on=a.graph_on, entity_ranks=ranks.to(st.device),
                ))
        return self._merge(parts, cfg.graph_top_k, row)

    def _tail(self, args: QueryArgs, lex, sem, gr, row: int = 0):
        """Fuse, expand to parents, rerank, gate: once per data row, on its device."""
        st, cfg = self.placement.rows[row], self.config
        w = args.weights
        fused = fuse_rrf(
            *lex, *sem, *gr, w[:, :3],
            rrf_k=cfg.rrf_k, top_k=cfg.rerank_top_k,
            score_blend=cfg.fusion_score_blend, lex_conf_gate=cfg.fusion_lex_conf_gate,
        )
        if cfg.conformal_denoise_enabled:
            keep = conformal_denoise_mask(fused.ids, fused.rrf, torch.tensor(cfg.conformal_alpha))
            fused = fused._replace(ids=torch.where(keep, fused.ids, torch.full_like(fused.ids, -1)))
        parent_of = st.parent_of
        safe = fused.ids.clamp(0, parent_of.shape[0] - 1)
        parent_ids = torch.where(fused.ids >= 0, parent_of.long()[safe], torch.full_like(safe, -1))
        if cfg.rerank_enabled and st.maxsim_tokens is not None:
            rerank = calibrate_maxsim(
                maxsim_scores(
                    st.maxsim_tokens, st.maxsim_mask, parent_ids, args.q_tokens.float(),
                    args.q_tok_mask.float(),
                ),
                self.maxsim_calibration,
            )
        elif cfg.rerank_enabled and self.dot_rerank and st.parent_emb is not None:
            # cosine against the parents' mean embeddings, mapped to [0, 1]
            pe = st.parent_emb[parent_ids.clamp(0, st.parent_emb.shape[0] - 1)]
            cos = torch.bmm(pe, args.q_vec.float()[:, :, None])[..., 0]
            rerank = torch.where(parent_ids >= 0, (cos + 1.0) * 0.5, torch.zeros_like(cos))
        else:
            rerank = minmax_normalize(fused.ids, fused.rrf)
        if cfg.rerank_enabled:
            bw = w[:, 3:4]
            order = (1.0 - bw) * rerank + bw * minmax_normalize(fused.ids, fused.rrf)
        else:
            order = rerank
        gate = apply_safety_denoise(
            fused.ids, order, args.threshold, args.alpha, top_k=cfg.final_top_k,
            gate_scores=rerank,
        )
        return gate.ids, gate.scores, gate.refused, gate.max_score, fused, rerank

    # ------------------------------------------------------------------ host API

    def search_arrays(
        self, queries: Sequence[str], collections: Optional[Sequence[Optional[str]]] = None
    ):
        """Prepare and run one batch; returns (plans, device outputs of :meth:`run`).

        Narrow batches (<= graph_sparse_max_batch) in which no plan requires the
        graph run without the graph channel: such queries get no seeds, so the
        channel would return nothing and the result is the same."""
        plans, args = self.prepare_queries(queries, collections)
        scoped = collections is not None and any(c is not None for c in collections)
        graph = not (
            self.state.has_graph
            and self.config.graph_enabled
            and len(queries) <= self.config.graph_sparse_max_batch
            and not any(p.requires_graph for p in plans)
        )
        return plans, self.run(args, scoped, graph)

    def _search_host(self, queries, colls):
        """:meth:`search_arrays` with its outputs copied to the host as numpy."""
        plans, (ids, scores, refused, max_score, fused, rerank) = self.search_arrays(
            queries, colls
        )
        with annotate("engine.fetch"):
            ids, scores, refused, max_score, rerank = (
                x.cpu().numpy() for x in (ids, scores, refused, max_score, rerank)
            )
            fused = FusedCandidates(*(x.cpu().numpy() for x in fused))
        return plans, (ids, scores, refused, max_score, fused, rerank)

    def retrieve(self, query: str, top_k: Optional[int] = None, collection: Optional[str] = None
                 ) -> RetrievalResult:
        return self.retrieve_batch([query], top_k=top_k, collection=collection)[0]

    def retrieve_batch(
        self,
        queries: Sequence[str],
        top_k: Optional[int] = None,
        collection: Optional[str] = None,
        collections: Optional[Sequence[Optional[str]]] = None,
    ) -> List[RetrievalResult]:
        """Batched retrieval with host decode. ``collection`` scopes the whole batch;
        ``collections`` scopes per query. The batch pads up to a multiple of the
        mesh's data axis with copies of the first query (each data row serves an
        equal slice); only the real queries' results return. While a profiler
        records, the call is the range ``engine.batch``, holding ``engine.prep``
        (:meth:`prepare_queries`), the program's ranges (:meth:`run`),
        ``engine.fetch`` (the copies back) and ``engine.decode``."""
        with annotate("engine.batch"):
            return self._retrieve_batch(queries, top_k, collection, collections)

    def _retrieve_batch(self, queries, top_k, collection, collections):
        n_real = len(queries)
        padded = list(queries)
        colls = list(collections) if collections is not None else [collection] * n_real
        while len(padded) % self.mesh.shape["data"]:
            padded.append(queries[0])
            colls.append(colls[0])
        t0 = time.perf_counter()
        try:
            plans, out = self._search_host(padded, colls)
        except RuntimeError:
            # a failure of the device encode can surface only at the copy back to the
            # host (kernels run asynchronously): retry once through the host path,
            # then restore the fast path
            if not self.device_query_encode:
                raise
            self.device_query_encode = False
            try:
                plans, out = self._search_host(padded, colls)
            finally:
                self.device_query_encode = True
        ids, scores, refused, max_score, fused, rerank = out
        plans = plans[:n_real]
        dispatch_ms = (time.perf_counter() - t0) * 1e3

        with annotate("engine.decode"):
            results: List[RetrievalResult] = []
            for i, (query, plan) in enumerate(zip(queries, plans)):
                t1 = time.perf_counter()
                fused_i = FusedCandidates(*(x[i] for x in fused))
                found = decode_results(self.corpus, fused_i, rerank[i], ids[i], scores[i])
                if top_k is not None:
                    found = found[:top_k]
                refused_b = bool(refused[i])
                decode_ms = (time.perf_counter() - t1) * 1e3
                results.append(
                    RetrievalResult(
                        query=query,
                        results=[] if refused_b else found,
                        plan=plan,
                        refused=refused_b,
                        refusal_reason=(
                            f"Max score {float(max_score[i]):.2f} below threshold "
                            f"{self.config.safety_threshold}" if refused_b else None
                        ),
                        max_score=float(max_score[i]),
                        timings={
                            "dispatch_ms": dispatch_ms / len(padded),
                            "decode_ms": decode_ms,
                            "total_ms": dispatch_ms / len(padded) + decode_ms,
                        },
                    )
                )
        return results
