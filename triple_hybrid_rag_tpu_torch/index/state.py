"""Device index state of the engine: the placed tensors and the host query tables.

The single-device counterpart of the JAX ``ShardedEngine``'s placement
(``parallel/engine.py`` ``__init__``) plus the host lookups a query needs: the
vocabulary and stored df of ``BM25Index.encode_query``/``encode_query_tiered`` and
the entity lookup of ``GraphIndex.seed_lookup``.

:meth:`IndexState.from_numpy` is the carry-over from the reference: it takes the
JAX retriever's index arrays as numpy (see its docstring for the keys) so that both
packages compute on identical indexes. :meth:`IndexState.from_tensors` takes
tensors already in the engine's layout (the synthetic corpus builds them on the
card). Both apply the reference's graph-backend policy. Under
``semantic_backend="ivf"`` the capacity rounds up to whole probe blocks and the
placed rows are replaced by their blocked-IVF layout, built on the device
(``parallel/engine.py``'s placement at one shard; :func:`ivf_layout`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyzer import Vocabulary
from ..config import RAGConfig
from ..models.entity_extractor import EntityStore
from ..ops.bm25 import DOC_PAD
from ..types import Entity
from .bm25_index import encode_query, encode_query_tiered
from .ivf import ivf_build_local


def _csr_layout(offsets, lengths, postings_doc, postings_weight):
    """The reference's per-shard CSR reshape (``_shard_csr``) at one shard: term
    blocks packed in term order, postings tail-padded by l_max (doc -1, weight 0).
    Returns (offsets i32[V+1], lengths i32[V], docs i32[W], weights f32[W], l_max)."""
    offs = np.asarray(offsets).astype(np.int64)
    lens = np.asarray(lengths).astype(np.int64)
    v = lens.shape[0]
    nnz = int(offs[-1])
    pd = np.asarray(postings_doc)
    pw = np.asarray(postings_weight)[:nnz].astype(np.float32)
    l_max = max(int(lens.max()) if nnz else 1, 1)
    out_offsets = np.zeros(v + 1, np.int32)
    np.cumsum(lens, out=out_offsets[1:])
    total = int(out_offsets[-1])
    out_pd = np.full(total + l_max, -1, np.int32)
    out_pw = np.zeros(total + l_max, np.float32)
    if total:
        idx = np.repeat(offs[:-1], lens) + (
            np.arange(total) - np.repeat(out_offsets[:-1].astype(np.int64), lens)
        )
        out_pd[:total] = pd[idx]
        out_pw[:total] = pw[idx]
    return out_offsets, lens.astype(np.int32), out_pd, out_pw, l_max


def mention_csr(ce_host: np.ndarray, e_pad: int, cap: int):
    """Invert chunk_entities[N, M] into an entity -> chunk mention CSR (the
    reference's ``_shard_mentions`` at one shard). Entities mentioned in more than
    ``cap`` chunks keep their ``cap`` lowest chunk rows.
    Returns (offsets i32[E+1], lengths i32[E], docs i32[W], l_max, truncated)."""
    n, m = ce_host.shape
    flat_ent = ce_host.reshape(-1).astype(np.int64)
    flat_doc = np.repeat(np.arange(n, dtype=np.int64), m)
    keep = (flat_ent >= 0) & (flat_ent < e_pad)
    fe, fd = flat_ent[keep], flat_doc[keep]
    order = np.lexsort((fd, fe))  # entity-major, chunk-ascending
    fe, fd = fe[order], fd[order]
    cnt = np.bincount(fe, minlength=e_pad)
    offs_full = np.zeros(e_pad + 1, np.int64)
    np.cumsum(cnt, out=offs_full[1:])
    pos_in_ent = np.arange(fe.shape[0]) - np.repeat(offs_full[:-1], cnt)
    k2 = pos_in_ent < cap
    truncated = bool((cnt > cap).any())
    fd = fd[k2]
    lens = np.minimum(cnt, cap)
    l_max = max(int(lens.max()) if fd.size else 1, 1)
    out_offsets = np.zeros(e_pad + 1, np.int32)
    np.cumsum(lens, out=out_offsets[1:])
    out_docs = np.full(fd.size + l_max, -1, np.int32)
    out_docs[: fd.size] = fd
    return out_offsets, lens.astype(np.int32), out_docs, l_max, truncated


def split_csr(
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    rows: torch.Tensor,
    weights: Optional[torch.Tensor],
    n_loc: int,
    n_shards: int,
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]], int]:
    """Split a packed CSR (the layouts of :func:`_csr_layout` and :func:`mention_csr`:
    blocks in key order, rows ascending within a block) into one CSR per shard of
    ``n_loc`` rows, on the tensors' device: the reference's ``_shard_csr`` and
    ``_shard_mentions`` after their global steps. Within a key, rows ascend, so
    each (key, shard) block is one contiguous run; a stable sort by (shard, key)
    lines the runs up shard by shard. Returns ([(offsets i32[V+1], lengths i32[V],
    local rows i32[W], weights f32[W] or None)] per shard, W = the shard's entries +
    l_max, tail -1 / 0; l_max the largest (key, shard) block, at least 1)."""
    v = lengths.shape[0]
    dev = rows.device
    total = int(offsets[-1])
    key = torch.repeat_interleave(torch.arange(v, device=dev), lengths.long())
    r = rows[:total].long()
    shard = torch.clamp(r // max(n_loc, 1), max=n_shards - 1)
    counts = torch.bincount(key * n_shards + shard, minlength=v * n_shards).view(v, n_shards)
    l_max = max(int(counts.max()) if total else 1, 1)
    order = torch.argsort(shard * v + key, stable=True)
    out, lo = [], 0
    for si, n_si in enumerate(counts.sum(dim=0).tolist()):
        idx = order[lo:lo + n_si]
        lo += n_si
        offs = torch.zeros(v + 1, dtype=torch.int32, device=dev)
        offs[1:] = torch.cumsum(counts[:, si], 0)
        local = torch.full((n_si + l_max,), -1, dtype=torch.int32, device=dev)
        local[:n_si] = r[idx] - si * n_loc
        w = None
        if weights is not None:
            w = torch.zeros((n_si + l_max,), dtype=torch.float32, device=dev)
            w[:n_si] = weights[:total][idx]
        out.append((offs, counts[:, si].to(torch.int32), local, w))
    return out, l_max


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor, including the ml_dtypes bfloat16 arrays JAX hands out."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a read-only view of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _pad_rows(t: torch.Tensor, n_rows: int, fill=None) -> torch.Tensor:
    """Pad the leading axis to ``n_rows`` with ``fill`` (default: -1 for integers,
    0/False otherwise)."""
    if t.shape[0] == n_rows:
        return t
    if fill is None:
        fill = -1 if not t.is_floating_point() and t.dtype != torch.bool else 0
    pad = t.new_full((n_rows - t.shape[0],) + tuple(t.shape[1:]), fill)
    return torch.cat([t, pad], 0)


@dataclass
class IndexState:
    """Placed index tensors (one device) + host query tables. Absent channels hold
    ``None``; the static statistics decide the engine's program variants."""

    config: RAGConfig
    device: torch.device
    n_pad: int
    # lexical: sorted CSR of precomputed BM25 weights, or the doc-major term table
    lexical_mode: str  # "sorted" | "termtable" | "none"
    lex_offsets: Optional[torch.Tensor]
    lex_lengths: Optional[torch.Tensor]
    lex_pd: Optional[torch.Tensor]
    lex_pt: Optional[torch.Tensor]
    lex_l_max: int
    term_ids: Optional[torch.Tensor]  # i32[n_pad, L], DOC_PAD in empty slots
    term_weights: Optional[torch.Tensor]  # f32[n_pad, L]
    vocab: Optional[Vocabulary]
    stored_df: Optional[np.ndarray]
    idf: Optional[np.ndarray]
    # dense
    embeddings: Optional[torch.Tensor]  # bf16|f32|i8[n_pad, D], or packed int4 u8[n_pad, D/2]
    dense_scales: Optional[torch.Tensor]  # f32[n_pad] row scales of quantized rows (1 on padding)
    valid: Optional[torch.Tensor]
    dim: int
    # graph
    graph_mode: str  # "none" | "sparse" | "dense"
    graph_small_sparse: bool
    graph_active: int
    graph_m: int
    nbr: Optional[torch.Tensor]
    chunk_entities: Optional[torch.Tensor]
    g_offsets: Optional[torch.Tensor]
    g_lengths: Optional[torch.Tensor]
    g_docs: Optional[torch.Tensor]
    g_l_max: int
    entity_store: Optional[EntityStore]
    row_of: Dict[str, int]
    seed_stop: Optional[np.ndarray]
    # scoping, expansion, rerank
    collection_of: torch.Tensor
    collection_ids: Dict[str, int]
    parent_of: torch.Tensor
    maxsim_tokens: Optional[torch.Tensor]  # bf16|i8[P, Td, Dm]
    maxsim_mask: Optional[torch.Tensor]
    corpus: Any = None  # view with child_by_row / parent (decode)
    # f32[P_pad, D] unit mean embeddings of each parent's chunks (the dot rerank)
    parent_emb: Optional[torch.Tensor] = None
    # blocked IVF (semantic_backend="ivf"): ``embeddings`` and ``dense_scales`` hold
    # the cluster-major rows, ``ivf_perm`` i64[n_pad] the original row of each slot
    # (n_pad = dead slot), ``ivf_centroids`` f32[n_pad / ivf_block_rows, D] the
    # block means
    ivf_perm: Optional[torch.Tensor] = None
    ivf_centroids: Optional[torch.Tensor] = None
    # the cross-encoder rerank (rerank_backend="cross_encoder"): each parent's
    # document as token ids, i32[P, W] (0 past its end) and i32[P], and the model,
    # which only the reranker reads (models/cross_encoder.document_arrays)
    xenc_doc_ids: Optional[torch.Tensor] = None
    xenc_doc_len: Optional[torch.Tensor] = None
    xenc_model: Any = None

    @property
    def has_graph(self) -> bool:
        return self.graph_mode != "none"

    @property
    def has_dense(self) -> bool:
        return self.embeddings is not None

    @property
    def ivf_mode(self) -> bool:
        return self.ivf_perm is not None

    # ------------------------------------------------------------------ builders

    @classmethod
    def from_numpy(
        cls,
        arrays: Mapping[str, np.ndarray],
        host: Mapping[str, Any],
        config: RAGConfig,
        device,
    ) -> "IndexState":
        """Carry the reference retriever's index arrays over to the port.

        ``arrays`` (numpy; every channel optional except ``parent_of``):
        ``parent_of`` i32[N]; ``bm25_offsets`` i32[V+1], ``bm25_lengths`` i32[V],
        ``bm25_postings_doc`` i32[W], ``bm25_postings_weight`` f32[W] (precomputed
        per-posting contributions), ``bm25_idf`` f32[V], ``bm25_term_ids`` i32[N, L] and
        ``bm25_term_weights`` f32/bf16[N, L] (the doc-major term table, placed when
        ``lexical_backend`` is "termtable" or "postings"); ``embeddings`` f32/bf16[N, D],
        int8[N, D] or packed int4 uint8[N, D/2] with ``dense_scales`` f32[N],
        ``valid`` bool[N]; ``nbr`` i32[E, Dg], ``chunk_entities`` i32[N, M];
        ``collection_of`` i32[N]; ``maxsim_tokens`` bf16/int8[P, Td, Dm],
        ``maxsim_mask`` bool[P, Td]; ``parent_emb`` f32[P_pad, D] (the reference
        reranker's ``parent_embeddings``, for the dot rerank); ``xenc_doc_ids``
        i32[P, W] and ``xenc_doc_len`` i32[P], the cross-encoder's document tokens,
        with its model as ``xenc_model`` (here or in ``host``).

        ``host``: ``vocab`` (list of terms), ``entity_keys`` + ``entities`` (the entity
        store's canonical keys and :class:`Entity` rows, in store order), ``row_of``,
        ``seed_stop`` (bool[E] or None), ``collection_ids``, ``corpus`` (a view for
        decoding), ``n_rows`` (the lexical table's capacity); or, in place of
        ``entity_keys`` + ``entities``, the ``entity_store`` itself. The MaxSim
        calibration is not the index's: the engine takes it from its embedder.
        An array may also come as a tensor, which moves to ``device`` as it is."""
        dev = torch.device(device)
        t: Dict[str, Any] = {}
        h = dict(host)
        if "bm25_offsets" in arrays:
            offs, lens, pd, pw, l_max = _csr_layout(
                arrays["bm25_offsets"], arrays["bm25_lengths"],
                arrays["bm25_postings_doc"], arrays["bm25_postings_weight"],
            )
            t.update(bm25_offsets=offs, bm25_lengths=lens, bm25_postings_doc=pd,
                     bm25_postings_weight=pw)
            h.update(bm25_l_max=l_max, stored_df=np.asarray(arrays["bm25_lengths"]),
                     idf=np.asarray(arrays["bm25_idf"], np.float32))
        for key in ("parent_of", "embeddings", "dense_scales", "valid", "nbr", "collection_of",
                    "maxsim_tokens", "maxsim_mask", "bm25_term_ids", "bm25_term_weights",
                    "parent_emb", "xenc_doc_ids", "xenc_doc_len"):
            if key in arrays and arrays[key] is not None:
                t[key] = arrays[key]
        if "chunk_entities" in arrays:
            t["chunk_entities"] = arrays["chunk_entities"]
            ce = arrays["chunk_entities"]
            h["chunk_entities_host"] = ce.cpu().numpy() if torch.is_tensor(ce) else np.asarray(ce)
        tensors = {
            k: v.to(dev) if torch.is_tensor(v) else _to_tensor(v, dev) for k, v in t.items()
        }
        if "xenc_model" in arrays:
            h["xenc_model"] = arrays["xenc_model"]
        return cls.from_tensors(tensors, h, config, dev)

    @classmethod
    def from_tensors(
        cls,
        tensors: Mapping[str, torch.Tensor],
        host: Mapping[str, Any],
        config: RAGConfig,
        device,
    ) -> "IndexState":
        """Place tensors already in the engine's layout (keys as in
        :meth:`from_numpy`, the CSR already reshaped; ``host`` adds ``bm25_l_max``,
        ``stored_df``, ``idf`` and ``chunk_entities_host``). ``config.lexical_backend``
        picks the lexical layout that is placed: the sorted CSR for "sorted"/"auto",
        the term table otherwise, and under "postings" the CSR as well (the staged
        retriever's scan). ``chunk_entities`` is placed in every graph mode."""
        cfg = config
        dev = torch.device(device)
        xenc_model = tensors.get("xenc_model", host.get("xenc_model"))
        tt = {k: v.to(dev) for k, v in tensors.items() if k != "xenc_model"}
        n_rows = [tt["parent_of"].shape[0], int(host.get("n_rows", 0))]
        n_rows += [tt[k].shape[0] for k in ("embeddings", "bm25_term_ids") if k in tt]
        n_pad = max(n_rows)
        ivf = cfg.semantic_backend == "ivf" and cfg.semantic_enabled and "embeddings" in tt
        if ivf:  # whole probe blocks (parallel/engine.py: capacity rounding)
            w = max(1, cfg.ivf_block_rows)
            n_pad = -(-n_pad // w) * w

        # ---- lexical ----
        lexical_mode = "none"
        lex = [None] * 4
        l_max = 1
        term_ids = term_weights = None
        vocab = stored_df = idf = None
        sorted_backend = cfg.lexical_backend in ("sorted", "auto")
        if cfg.lexical_enabled and ("bm25_offsets" if sorted_backend else "bm25_term_ids") in tt:
            # the CSR serves the sorted backends, and under "postings" the staged
            # retriever's term-at-a-time scan (the engine reads the term table there)
            if sorted_backend or (cfg.lexical_backend == "postings" and "bm25_offsets" in tt):
                lex = [tt["bm25_offsets"].int(), tt["bm25_lengths"].int(),
                       tt["bm25_postings_doc"].int(), tt["bm25_postings_weight"].float()]
                l_max = int(host["bm25_l_max"])
                stored_df = np.asarray(host["stored_df"])
                idf = np.asarray(host["idf"], np.float32)
            if sorted_backend:
                lexical_mode = "sorted"
            else:  # "termtable" / "postings": the doc-major table, weights in f32
                lexical_mode = "termtable"
                term_ids = _pad_rows(tt["bm25_term_ids"].int(), n_pad, fill=DOC_PAD).contiguous()
                term_weights = _pad_rows(tt["bm25_term_weights"].float(), n_pad).contiguous()
            terms = host["vocab"]
            vocab = terms if isinstance(terms, Vocabulary) else Vocabulary.from_list(terms)

        # ---- dense ----
        embeddings = dense_scales = valid = None
        dim = 8
        if "embeddings" in tt:
            embeddings = _pad_rows(tt["embeddings"], n_pad, fill=0)
            valid = _pad_rows(tt["valid"].bool(), n_pad)
            dim = embeddings.shape[1]
            if embeddings.dtype in (torch.int8, torch.uint8):
                if "dense_scales" not in tt:
                    raise ValueError("int8/int4 dense rows need their dense_scales")
                dense_scales = _pad_rows(tt["dense_scales"].float(), n_pad, fill=1.0)
                if embeddings.dtype == torch.uint8:
                    dim *= 2  # two columns per packed byte

        # ---- graph: the reference's backend policy (parallel/engine.py) ----
        graph_mode = "none"
        graph_small_sparse = False
        graph_active, g_l_max, graph_m = 1, 1, 1
        nbr = chunk_entities = None
        g_csr = [None] * 3
        store = None
        if "nbr" in tt:
            nbr = tt["nbr"].int()
            e_pad = nbr.shape[0]
            ce_host = host["chunk_entities_host"]
            graph_m = int(ce_host.shape[1])
            backend = cfg.graph_backend
            deg = int(nbr.shape[1])
            reach, bound = 1, 1
            for _ in range(cfg.graph_hops):
                reach *= deg
                bound += reach
            bound = min(cfg.graph_max_seeds * bound, e_pad)
            a_slots = min(bound, cfg.graph_active_slots)
            want_small = cfg.graph_sparse_max_batch > 0
            if backend in ("sparse", "auto") and (
                backend == "sparse" or bound <= cfg.graph_active_slots or want_small
            ):
                g_off, g_len, g_docs, l_max_g, truncated = mention_csr(
                    ce_host, e_pad, cfg.graph_mention_cap
                )
                exact = (not truncated) and bound <= cfg.graph_active_slots
                if backend == "sparse" or exact or want_small:
                    graph_active = a_slots
                    g_l_max = l_max_g
                    g_csr = [torch.from_numpy(x).to(dev) for x in (g_off, g_len, g_docs)]
                    if backend == "sparse" or exact:
                        graph_mode = "sparse"
                    else:
                        graph_small_sparse = True
            if graph_mode != "sparse":
                graph_mode = "dense"
            # the dense scan's table; the sparse mode's engine walks the mention CSR
            # instead, but the staged retriever scans this table in every mode
            chunk_entities = _pad_rows(tt["chunk_entities"].int(), n_pad)
            store = host.get("entity_store") or EntityStore.from_items(
                zip(host["entity_keys"], host["entities"])
            )

        collection_of = (
            _pad_rows(tt["collection_of"].int(), n_pad)
            if "collection_of" in tt
            else torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        )
        tokens = mask = None
        if "maxsim_tokens" in tt:
            # an int8 store stays int8, as in the reference (the kernel dequantizes the
            # gathered rows); float stores are scored in bf16
            tokens = tt["maxsim_tokens"]
            if tokens.dtype != torch.int8:
                tokens = tokens.to(torch.bfloat16)
            tokens = tokens.contiguous()
            mask = tt["maxsim_mask"].bool()
        state = cls(
            config=cfg, device=dev, n_pad=n_pad,
            lexical_mode=lexical_mode, lex_offsets=lex[0], lex_lengths=lex[1],
            lex_pd=lex[2], lex_pt=lex[3], lex_l_max=l_max,
            term_ids=term_ids, term_weights=term_weights,
            vocab=vocab, stored_df=stored_df, idf=idf,
            embeddings=embeddings, dense_scales=dense_scales, valid=valid, dim=dim,
            graph_mode=graph_mode, graph_small_sparse=graph_small_sparse,
            graph_active=graph_active, graph_m=graph_m, nbr=nbr,
            chunk_entities=chunk_entities, g_offsets=g_csr[0], g_lengths=g_csr[1],
            g_docs=g_csr[2], g_l_max=g_l_max, entity_store=store,
            row_of=dict(host.get("row_of", {})), seed_stop=host.get("seed_stop"),
            collection_of=collection_of,
            collection_ids=dict(host.get("collection_ids", {})),
            parent_of=_pad_rows(tt["parent_of"].int(), n_pad),
            maxsim_tokens=tokens, maxsim_mask=mask,
            corpus=host.get("corpus"),
            parent_emb=tt["parent_emb"].float().contiguous() if "parent_emb" in tt else None,
            xenc_doc_ids=tt["xenc_doc_ids"].int().contiguous() if "xenc_doc_ids" in tt else None,
            xenc_doc_len=tt["xenc_doc_len"].int() if "xenc_doc_ids" in tt else None,
            xenc_model=xenc_model,
        )
        return ivf_layout(state, cfg) if ivf else state

    # ------------------------------------------------------------------ host lookups

    def encode_query(self, keywords: Sequence[str]) -> np.ndarray:
        """Keywords -> padded i32[max_query_terms] term ids (OOV / pad = -1)."""
        return encode_query(self.vocab, keywords, self.config.max_query_terms)

    def encode_query_tiered(
        self, keywords: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(small_terms, small_slots, large_terms, large_slots) of the df-tiered
        sorted path (``bm25_index.encode_query_tiered``)."""
        return encode_query_tiered(
            self.encode_query(keywords), self.stored_df, self.idf, self.config
        )

    def seed_lookup(self, name: str, limit: int = 3) -> List[Entity]:
        """Entity lookup minus the seed stoplist (``graph_index.seed_lookup``)."""
        from .graph_index import seed_lookup

        return seed_lookup(self.entity_store, self.row_of, self.seed_stop, self.config, name, limit)

    def nbytes(self) -> Dict[str, int]:
        """Device bytes per placed component (for reporting)."""
        parts = {
            "embeddings": [self.embeddings, self.dense_scales, self.valid],
            "postings": [self.lex_offsets, self.lex_lengths, self.lex_pd, self.lex_pt],
            "term_table": [self.term_ids, self.term_weights],
            "maxsim": [self.maxsim_tokens, self.maxsim_mask],
            "graph": [self.nbr, self.chunk_entities, self.g_offsets, self.g_lengths, self.g_docs],
            "tables": [self.parent_of, self.collection_of],
            "parent_emb": [self.parent_emb],
            "ivf": [self.ivf_perm, self.ivf_centroids],
            "cross_encoder": [self.xenc_doc_ids, self.xenc_doc_len],
        }
        out = {
            k: sum(t.numel() * t.element_size() for t in v if t is not None)
            for k, v in parts.items()
        }
        if self.xenc_model is not None:
            out["cross_encoder"] += self.xenc_model.nbytes()
        return out


def ivf_layout(state: IndexState, config: RAGConfig) -> IndexState:
    """``state`` under ``config`` (``semantic_backend="ivf"``) with its placed rows
    replaced by their blocked-IVF layout, built on the rows' device: the
    cluster-major rows and row scales, the permutation and the block centroids
    (``ivf_build_local`` with the config's block width, cluster count and k-means
    iterations). ``state.n_pad`` must be a multiple of ``ivf_block_rows``."""
    rows, scales, perm, cent = ivf_build_local(
        state.embeddings, state.dense_scales, state.valid,
        block_rows=max(1, config.ivf_block_rows), n_clusters=config.ivf_clusters,
        iters=config.ivf_kmeans_iters,
    )
    return dataclasses.replace(
        state, config=config, embeddings=rows, dense_scales=scales, ivf_perm=perm,
        ivf_centroids=cent,
    )
