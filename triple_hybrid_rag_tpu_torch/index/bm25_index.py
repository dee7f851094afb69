"""BM25 index build: child texts -> the lexical arrays (both layouts).

The port of the JAX package's ``index/bm25_index.py`` build. The reference's build is
NumPy throughout, so this copy gives bit-equal arrays: the CSR postings (term-major,
each term's postings capped at ``bm25_df_cap`` keeping the highest tf, tail-padded
by the longest window), the per-posting BM25 weights folded at build, the idf over
the true document frequency, and the doc-major term table (``doc_term_capacity``
slots, overflow keeps the heaviest terms). The arrays stay on the host:
:meth:`IndexState.from_numpy <triple_hybrid_rag_tpu_torch.index.state.IndexState.from_numpy>`
places the layout the config selects. The reference's C++ build of the same arrays
(``native.py``) is not ported (ROADMAP.md, Queue 1).

The staged retriever's lexical channel (:func:`lexical_scores`,
:func:`lexical_search`, :func:`lexical_search_sorted`, the ports of
``BM25Index.score`` / ``search`` / ``search_sorted``) reads the placed
:class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState`, the engine's own copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyzer import Analyzer, Vocabulary
from ..config import RAGConfig
from ..ops.bm25 import DOC_PAD, score_postings, score_postings_topk_pre, score_termtable
from ..ops.topk import masked_top_k

# "auto": corpora of at least this many documents take the sorted postings
AUTO_SORTED_DOCS = 4096


@dataclass
class BM25Index:
    """The lexical arrays of one corpus snapshot, as host NumPy."""

    offsets: np.ndarray  # i32[V + 1] CSR term offsets
    lengths: np.ndarray  # i32[V] stored postings per term (capped df)
    postings_doc: np.ndarray  # i32[nnz + l_max], n_pad in the tail
    postings_weight: np.ndarray  # f32[nnz + l_max] precomputed BM25 contributions
    term_ids: np.ndarray  # i32[n_pad, L] doc-major term table, DOC_PAD in empty slots
    term_weights: np.ndarray  # f32[n_pad, L]
    idf: np.ndarray  # f32[V]
    n_docs: int
    n_pad: int
    l_max: int  # longest stored postings window
    vocab: Vocabulary
    overflow_docs: int = 0  # docs whose unique terms exceeded doc_term_capacity

    def arrays(self) -> Dict[str, np.ndarray]:
        """The ``bm25_*`` arrays of :meth:`IndexState.from_numpy`."""
        return {
            "bm25_offsets": self.offsets, "bm25_lengths": self.lengths,
            "bm25_postings_doc": self.postings_doc, "bm25_postings_weight": self.postings_weight,
            "bm25_idf": self.idf, "bm25_term_ids": self.term_ids,
            "bm25_term_weights": self.term_weights,
        }


def tokenize_corpus(
    texts: Sequence[str], analyzer: Analyzer, vocab: Optional[Vocabulary] = None
) -> Tuple[List[List[int]], Vocabulary]:
    """Tokenize + encode all documents, growing the vocabulary."""
    vocab = vocab or Vocabulary()
    return [vocab.encode(analyzer.tokenize(t), add=True) for t in texts], vocab


def build_bm25_index(
    texts: Sequence[str],
    config: RAGConfig,
    analyzer: Optional[Analyzer] = None,
    vocab: Optional[Vocabulary] = None,
    token_ids: Optional[List[List[int]]] = None,
) -> BM25Index:
    """Build the lexical index from child-chunk texts (the reference's pure
    Python/NumPy build; its C++ fast path gives the same arrays)."""
    analyzer = analyzer or Analyzer(config)
    if token_ids is None:
        token_ids, vocab = tokenize_corpus(texts, analyzer, vocab)
    assert vocab is not None
    n_docs = len(token_ids)
    n_pad = config.round_capacity(max(n_docs, 1))
    vsize = max(len(vocab), 1)

    # per-doc tf maps and lengths
    doc_tfs: List[Dict[int, int]] = []
    doc_lengths = np.zeros((n_pad,), dtype=np.float32)
    for d, toks in enumerate(token_ids):
        tf: Dict[int, int] = {}
        for t in toks:
            if t >= 0:
                tf[t] = tf.get(t, 0) + 1
        doc_tfs.append(tf)
        doc_lengths[d] = len(toks)
    avgdl = float(doc_lengths[:n_docs].mean()) if n_docs else 1.0

    # document frequency and CSR assembly (term-major)
    df = np.zeros((vsize,), dtype=np.int64)
    for tf in doc_tfs:
        for t in tf:
            df[t] += 1
    # impact pruning: cap each term's stored postings at bm25_df_cap, keeping the
    # highest-tf entries (ultra-common terms carry near-zero idf; the cap bounds the
    # sorted-path gather window). idf still uses the TRUE df.
    cap = config.bm25_df_cap if config.bm25_df_cap > 0 else 0
    stored_df = np.minimum(df, cap) if cap else df.copy()
    l_max = int(stored_df.max()) if n_docs else 1
    l_max = max(l_max, 1)
    offsets = np.zeros((vsize + 1,), dtype=np.int32)
    np.cumsum(stored_df, out=offsets[1:])
    nnz = int(offsets[-1])
    postings_doc = np.full((nnz + l_max,), n_pad, dtype=np.int32)
    postings_tf = np.zeros((nnz + l_max,), dtype=np.float32)
    if cap:
        # term-major assembly with per-term top-tf selection
        term_postings: Dict[int, List[Tuple[int, int]]] = {}
        for d, tf in enumerate(doc_tfs):
            for t, cnt in tf.items():
                term_postings.setdefault(t, []).append((d, cnt))
        for t, plist in term_postings.items():
            if len(plist) > cap:
                plist = sorted(plist, key=lambda x: -x[1])[:cap]
                plist.sort()  # keep doc order within the window
            base = offsets[t]
            for i, (d, cnt) in enumerate(plist):
                postings_doc[base + i] = d
                postings_tf[base + i] = cnt
    else:
        cursor = offsets[:-1].copy()
        for d, tf in enumerate(doc_tfs):
            for t, cnt in tf.items():
                postings_doc[cursor[t]] = d
                postings_tf[cursor[t]] = cnt
                cursor[t] += 1

    # shared stats — pure NumPy on host: the build path must not issue eager device ops
    # (each one is a dispatch; prohibitive over remote-TPU links)
    denom = (
        config.bm25_k1
        * (1.0 - config.bm25_b + config.bm25_b * doc_lengths / max(avgdl, 1e-6))
    ).astype(np.float32)
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)

    # doc-major term table with precomputed contributions; overflow keeps top-L by weight
    L = config.doc_term_capacity
    term_ids = np.full((n_pad, L), DOC_PAD, dtype=np.int32)
    term_weights = np.zeros((n_pad, L), dtype=np.float32)
    k1p1 = config.bm25_k1 + 1.0
    overflow = 0
    for d, tf in enumerate(doc_tfs):
        if not tf:
            continue
        ts = np.fromiter(tf.keys(), dtype=np.int32, count=len(tf))
        cs = np.fromiter(tf.values(), dtype=np.float32, count=len(tf))
        w = idf[ts] * cs * k1p1 / (cs + denom[d])
        if len(ts) > L:
            overflow += 1
            # two-key (weight desc, term-id asc) selection + canonical term-id-ascending
            # slot order — matches the native overflow path exactly even on tied weights
            keep = np.lexsort((ts, -w))[:L]
            keep = keep[np.argsort(ts[keep], kind="stable")]
            ts, w = ts[keep], w[keep]
        term_ids[d, : len(ts)] = ts
        term_weights[d, : len(ts)] = w

    stored_df_i32 = stored_df.astype(np.int32)
    pw = _fold_posting_weights(
        postings_doc, postings_tf, nnz, stored_df, idf, denom, n_pad, k1p1
    )
    return BM25Index(
        offsets=offsets,
        lengths=stored_df_i32,  # stored window; idf keeps true df
        postings_doc=postings_doc,
        postings_weight=pw,
        term_ids=term_ids,
        term_weights=term_weights,
        idf=idf,
        n_docs=n_docs,
        n_pad=n_pad,
        l_max=l_max,
        vocab=vocab,
        overflow_docs=overflow,
    )


def _fold_posting_weights(
    postings_doc: np.ndarray,
    postings_tf: np.ndarray,
    nnz: int,
    stored_df: np.ndarray,
    idf: np.ndarray,
    denom: np.ndarray,
    n_pad: int,
    k1p1: float,
) -> np.ndarray:
    """Per-posting BM25 contribution: idf[t] * tf * (k1+1) / (tf + denom[d])."""
    pw = np.zeros_like(postings_tf)
    if nnz:
        term_of = np.repeat(np.arange(stored_df.shape[0]), stored_df)
        docs = np.clip(postings_doc[:nnz], 0, n_pad - 1)
        tfs = postings_tf[:nnz]
        pw[:nnz] = idf[term_of] * tfs * k1p1 / (tfs + denom[docs])
    return pw


# ---------------------------------------------------------------- staged channel


def _n_docs(state) -> int:
    return len(state.corpus) if state.corpus is not None else state.n_pad


def lexical_scores(state, query_terms: torch.Tensor) -> torch.Tensor:
    """Dense f32[n_pad] BM25 scores of one padded query-term vector over the placed
    state (the reference's ``BM25Index.score``): ``"postings"`` adds the CSR windows
    term at a time, ``"termtable"`` launches the term-table kernel on CUDA; under
    ``"auto"`` corpora below :data:`AUTO_SORTED_DOCS` documents take the postings."""
    backend = state.config.lexical_backend
    if backend == "auto":
        backend = "termtable" if _n_docs(state) >= AUTO_SORTED_DOCS else "postings"
    if backend == "postings" and state.lex_offsets is not None:
        return score_postings(
            state.lex_offsets, state.lex_lengths, state.lex_pd, state.lex_pt, query_terms,
            l_max=state.lex_l_max, n_pad=state.n_pad,
        )
    if backend == "termtable" and state.term_ids is not None:
        return score_termtable(state.term_ids, state.term_weights, query_terms)
    raise ValueError(f"the placed state has no layout for the {backend!r} lexical backend")


def lexical_search(
    state, keywords: Sequence[str], top_k: Optional[int] = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The staged lexical channel: keywords -> (ids i64[k], scores f32[k]) (the
    reference's ``BM25Index.search``). ``row_mask`` bool[n_pad] scopes the rows."""
    cfg = state.config
    k = top_k or cfg.lexical_top_k
    qt = torch.from_numpy(state.encode_query(keywords)).to(state.device)
    backend = cfg.lexical_backend
    if backend == "sorted" or (backend == "auto" and _n_docs(state) >= AUTO_SORTED_DOCS):
        return lexical_search_sorted(state, qt, k, row_mask)
    return masked_top_k(lexical_scores(state, qt), k, valid=row_mask)


def lexical_search_sorted(
    state, query_terms: torch.Tensor, top_k: int, row_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based sparse top-k of one query, O(matched postings) (the reference's
    ``BM25Index.search_sorted``): the batched op at one query."""
    ids, vals = score_postings_topk_pre(
        state.lex_offsets, state.lex_lengths, state.lex_pd, state.lex_pt, query_terms[None, :],
        None if row_mask is None else row_mask[None, :],
        l_max=state.lex_l_max, n_pad=state.n_pad, top_k=top_k,
    )
    return ids[0], vals[0]
