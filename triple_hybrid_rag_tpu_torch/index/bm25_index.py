"""BM25 index build: child texts -> the lexical arrays (both layouts).

The port of the JAX package's ``index/bm25_index.py`` build. The reference's build is
NumPy throughout, so this copy gives bit-equal arrays: the CSR postings (term-major,
each term's postings capped at ``bm25_df_cap`` keeping the highest tf, tail-padded
by the longest window), the per-posting BM25 weights folded at build, the idf over
the true document frequency, and the doc-major term table (``doc_term_capacity``
slots, overflow keeps the heaviest terms). The arrays stay on the host:
:meth:`IndexState.from_numpy <triple_hybrid_rag_tpu_torch.index.state.IndexState.from_numpy>`
places the layout the config selects. Under the reference's conditions the build
goes through the C++ tokenizer and postings assembly (``native.py``,
:func:`_build_native`), which gives the same arrays.

The staged retriever's lexical channel (:func:`lexical_scores`,
:func:`lexical_search`, :func:`lexical_search_sorted`, the ports of
``BM25Index.score`` / ``search`` / ``search_sorted``) reads the placed
:class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState`, the engine's own copy.
The index's own :meth:`BM25Index.score`, :meth:`~BM25Index.search` and
:meth:`~BM25Index.search_sorted` run the same functions over a copy of its arrays
placed once on the device the caller names (:meth:`BM25Index.placed`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyzer import Analyzer, Vocabulary
from ..config import RAGConfig
from ..device import resolve_device
from ..ops.bm25 import (
    DOC_PAD,
    QUERY_PAD,
    score_postings_pre,
    score_postings_topk_tiered,
    score_termtable,
)
from ..ops.topk import masked_top_k

# "auto": corpora of at least this many documents take the sorted postings
AUTO_SORTED_DOCS = 4096


@dataclass
class BM25Index:
    """The lexical arrays of one corpus snapshot, as host NumPy, with the
    reference's fields: the term frequencies and per-document denominators the
    reference's ``score_postings`` reads, and ``host_csr`` / ``host_weights``,
    which here are the record's own arrays (filled when not given)."""

    offsets: np.ndarray  # i32[V + 1] CSR term offsets
    lengths: np.ndarray  # i32[V] stored postings per term (capped df)
    postings_doc: np.ndarray  # i32[nnz + l_max], n_pad in the tail
    postings_tf: np.ndarray  # f32[nnz + l_max] term frequency per posting
    term_ids: np.ndarray  # i32[n_pad, L] doc-major term table, DOC_PAD in empty slots
    term_weights: np.ndarray  # f32[n_pad, L]
    contrib_denom_k1: np.ndarray  # f32[n_pad] per-doc k1 * (1 - b + b * dl / avgdl)
    idf: np.ndarray  # f32[V]
    n_docs: int
    n_pad: int
    l_max: int  # longest stored postings window
    vocab: Vocabulary
    config: Optional[RAGConfig] = None  # the build's (query width, backend, tiers)
    overflow_docs: int = 0  # docs whose unique terms exceeded doc_term_capacity
    # (offsets, lengths, postings_doc, postings_tf), as the reference keeps them
    host_csr: Optional[tuple] = None
    # f32[nnz + l_max] precomputed BM25 contribution per posting (folded from the
    # term frequencies when not given); ``host_weights`` is the same array
    postings_weight: Optional[np.ndarray] = None
    host_weights: Optional[np.ndarray] = None
    # device -> the arrays placed there (:meth:`placed`)
    _placed: Dict[str, "PlacedLexical"] = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.host_csr is None:
            self.host_csr = (self.offsets, self.lengths, self.postings_doc, self.postings_tf)
        if self.postings_weight is None:
            self.postings_weight = (
                self.host_weights if self.host_weights is not None
                else _fold_posting_weights(
                    self.postings_doc, self.postings_tf, int(self.offsets[-1]),
                    np.asarray(self.lengths, np.int64), self.idf, self.contrib_denom_k1,
                    self.n_pad, (self.config or RAGConfig()).bm25_k1 + 1.0,
                )
            )
        if self.host_weights is None:
            self.host_weights = self.postings_weight

    def arrays(self) -> Dict[str, np.ndarray]:
        """The ``bm25_*`` arrays of :meth:`IndexState.from_numpy`."""
        return {
            "bm25_offsets": self.offsets, "bm25_lengths": self.lengths,
            "bm25_postings_doc": self.postings_doc, "bm25_postings_weight": self.postings_weight,
            "bm25_idf": self.idf, "bm25_term_ids": self.term_ids,
            "bm25_term_weights": self.term_weights,
        }

    def encode_query(self, keywords: Sequence[str]) -> np.ndarray:
        """Keywords -> padded i32[max_query_terms] term ids (OOV / pad = -1)."""
        return encode_query(self.vocab, keywords, self.config.max_query_terms)

    def encode_query_tiered(
        self, keywords: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(small_terms, small_slots, large_terms, large_slots) of the df-tiered sorted
        path (see :func:`encode_query_tiered`)."""
        return encode_query_tiered(self.encode_query(keywords), self.lengths, self.idf, self.config)

    def placed(self, device=None) -> "PlacedLexical":
        """The arrays on ``device`` (CUDA unless ``device="cpu"``), placed on the
        first call for that device and kept on the index."""
        dev = resolve_device(device)
        view = self._placed.get(str(dev))
        if view is None:
            view = self._placed[str(dev)] = PlacedLexical(
                index=self, config=self.config, device=dev,
                lex_offsets=torch.from_numpy(self.offsets).to(dev),
                lex_lengths=torch.from_numpy(self.lengths).to(dev),
                lex_pd=torch.from_numpy(self.postings_doc).to(dev),
                lex_pt=torch.from_numpy(self.postings_weight).to(dev),
                term_ids=torch.from_numpy(self.term_ids).to(dev),
                term_weights=torch.from_numpy(self.term_weights).to(dev),
            )
        return view

    def score(self, query_terms, backend: Optional[str] = None, device=None) -> torch.Tensor:
        """Dense f32[n_pad] BM25 scores of one padded query-term vector (numpy or a
        tensor, whose device then places the index). ``backend`` defaults to the
        config's; under "auto" corpora of :data:`AUTO_SORTED_DOCS` documents or more
        take the term table (the term-table kernel on CUDA)."""
        view = self.placed(query_terms.device if torch.is_tensor(query_terms) else device)
        return lexical_scores(view, _on(query_terms, view.device), backend)

    def search(
        self, keywords: Sequence[str], top_k: Optional[int] = None, row_mask=None, device=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The lexical channel: keywords -> (ids i64[k], scores f32[k]) on the device
        of ``row_mask`` (bool[n_pad]) when it is a tensor, else on ``device``."""
        view = self.placed(row_mask.device if torch.is_tensor(row_mask) else device)
        return lexical_search(view, keywords, top_k, _mask_on(row_mask, view.device))

    def search_sorted(
        self, query_terms, top_k: int, row_mask=None, device=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sort-based sparse top-k of one padded query-term vector, O(matched
        postings): :func:`lexical_search_sorted` over the placed arrays."""
        view = self.placed(query_terms.device if torch.is_tensor(query_terms) else device)
        return lexical_search_sorted(
            view, _on(query_terms, view.device), top_k, _mask_on(row_mask, view.device)
        )


@dataclass
class PlacedLexical:
    """A :class:`BM25Index`'s arrays on one device, under the names of
    :class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState` that the staged
    lexical channel reads."""

    index: BM25Index
    config: RAGConfig
    device: torch.device
    lex_offsets: torch.Tensor
    lex_lengths: torch.Tensor
    lex_pd: torch.Tensor
    lex_pt: torch.Tensor
    term_ids: torch.Tensor
    term_weights: torch.Tensor

    @property
    def n_pad(self) -> int:
        return self.index.n_pad

    @property
    def n_docs(self) -> int:
        return self.index.n_docs

    @property
    def lex_l_max(self) -> int:
        return self.index.l_max

    def encode_query(self, keywords: Sequence[str]) -> np.ndarray:
        return self.index.encode_query(keywords)


def _on(x, device: torch.device) -> torch.Tensor:
    """A tensor or array-like on ``device``."""
    return x.to(device) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=device)


def _mask_on(row_mask, device: torch.device) -> Optional[torch.Tensor]:
    return None if row_mask is None else _on(row_mask, device).bool()


def encode_query(vocab: Vocabulary, keywords: Sequence[str], max_terms: int) -> np.ndarray:
    """Keywords -> padded i32[max_terms] term ids: known terms, each once, in order
    (OOV / pad = -1)."""
    ids: List[int] = []
    seen: set = set()
    for kw in keywords:
        tid = vocab.get(kw)
        if tid >= 0 and tid not in seen:
            seen.add(tid)
            ids.append(tid)
        if len(ids) >= max_terms:
            break
    out = np.full((max_terms,), QUERY_PAD, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def encode_query_tiered(
    qt: np.ndarray, stored_df: np.ndarray, idf: np.ndarray, config: RAGConfig
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(small_terms, small_slots, large_terms, large_slots) of an encoded query:
    terms with stored df <= bm25_small_window go to the small tier; the large tier
    keeps the bm25_large_slots rarest (by idf, monotone in the true df). Slots are
    the original query positions."""
    small, large = [], []
    for slot, t in enumerate(qt):
        if t < 0:
            continue
        (small if stored_df[t] <= config.bm25_small_window else large).append((int(t), slot))
    large.sort(key=lambda ts: -float(idf[ts[0]]))
    large = large[: config.bm25_large_slots]

    def pad(pairs, cap):
        terms = np.full((cap,), -1, np.int32)
        slots = np.zeros((cap,), np.int32)
        for i, (t, s) in enumerate(pairs[:cap]):
            terms[i], slots[i] = t, s
        return terms, slots

    st, ss = pad(small, config.max_query_terms)
    lt, ls = pad(large, config.bm25_large_slots)
    return st, ss, lt, ls


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
    """Build the lexical index from child-chunk texts.

    Takes the C++ fast path (``native.py``) for tokenization and postings assembly
    when its library is built and the reference's conditions hold; otherwise the
    pure-Python/NumPy build. Both give the same arrays."""
    # the native path only where the stock analyzer's semantics apply: a custom
    # Analyzer subclass must tokenize the index itself, and the C++ tokenizer always
    # folds accents, so strip_accents=False stays on the Python build
    stock_analyzer = analyzer is None or type(analyzer) is Analyzer
    if (
        token_ids is None and vocab is None and stock_analyzer
        and config.use_native and config.analyzer_strip_accents
    ):
        from .. import native

        if native.available():
            return _build_native(texts, config)
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
        postings_tf=postings_tf,
        postings_weight=pw,
        term_ids=term_ids,
        term_weights=term_weights,
        contrib_denom_k1=denom,
        idf=idf,
        n_docs=n_docs,
        n_pad=n_pad,
        l_max=l_max,
        vocab=vocab,
        overflow_docs=overflow,
        config=config,
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


def _build_native(texts: Sequence[str], config: RAGConfig) -> BM25Index:
    """The C++ build: native tokenization and postings assembly, then the NumPy
    finish of the reference's ``_build_native`` (the same df capping by top tf, the
    same layouts), giving the Python build's arrays."""
    from .. import native

    na = native.NativeAnalyzer(config)
    if texts:
        tokens, tok_offsets = na.tokenize_batch(list(texts), add_to_vocab=True)
    else:
        tokens = np.zeros(0, np.int32)
        tok_offsets = np.zeros(1, np.int64)
    vocab = Vocabulary.from_list(na.vocab_terms())
    n_docs = len(texts)
    n_pad = config.round_capacity(max(n_docs, 1))
    vsize = max(len(vocab), 1)

    df, doc_len = native.native_postings_count(tokens, tok_offsets, vsize)
    doc_lengths = np.zeros(n_pad, np.float32)
    doc_lengths[:n_docs] = doc_len
    avgdl = float(doc_lengths[:n_docs].mean()) if n_docs else 1.0
    denom = (
        config.bm25_k1
        * (1.0 - config.bm25_b + config.bm25_b * doc_lengths / max(avgdl, 1e-6))
    ).astype(np.float32)
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)
    k1p1 = config.bm25_k1 + 1.0

    res = native.native_postings_fill(
        tokens, tok_offsets, vsize, df, idf, denom[:n_docs], k1p1, config.doc_term_capacity,
    )

    # df capping (top tf per oversized term, as the Python build)
    cap = config.bm25_df_cap if config.bm25_df_cap > 0 else 0
    full_offsets = res["csr_offsets"]
    pd_full, pt_full = res["postings_doc"], res["postings_tf"]
    if cap:
        stored_df = np.minimum(df, cap)
        offsets = np.zeros(vsize + 1, np.int64)
        np.cumsum(stored_df, out=offsets[1:])
        nnz = int(offsets[-1])
        l_max = max(int(stored_df.max()) if n_docs else 1, 1)
        postings_doc = np.full(nnz + l_max, n_pad, np.int32)
        postings_tf = np.zeros(nnz + l_max, np.float32)
        for t in range(vsize):
            s, e = int(full_offsets[t]), int(full_offsets[t + 1])
            o = int(offsets[t])
            if e - s <= cap:
                postings_doc[o : o + e - s] = pd_full[s:e]
                postings_tf[o : o + e - s] = pt_full[s:e]
            else:
                # two keys (tf desc, doc asc): the Python build's stable
                # sorted(key=-tf)[:cap] over a doc-ascending list, ties included
                sel = np.lexsort((np.arange(e - s), -pt_full[s:e]))[:cap]
                sel.sort()  # doc-ascending inside the window
                postings_doc[o : o + cap] = pd_full[s:e][sel]
                postings_tf[o : o + cap] = pt_full[s:e][sel]
        stored_df_i32 = stored_df.astype(np.int32)
    else:
        l_max = max(int(df.max()) if n_docs else 1, 1)
        nnz = int(full_offsets[-1])
        offsets = full_offsets
        postings_doc = np.full(nnz + l_max, n_pad, np.int32)
        postings_tf = np.zeros(nnz + l_max, np.float32)
        postings_doc[:nnz] = pd_full
        postings_tf[:nnz] = pt_full
        stored_df_i32 = df.astype(np.int32)

    # term table: idf and tf saturation folded into the weights
    L = config.doc_term_capacity
    term_ids = np.full((n_pad, L), DOC_PAD, dtype=np.int32)
    term_weights = np.zeros((n_pad, L), dtype=np.float32)
    if n_docs:
        table_ids = res["table_ids"]
        term_ids[:n_docs] = table_ids
        valid_slots = table_ids >= 0
        safe_ids = np.where(valid_slots, table_ids, 0)
        tfs = res["table_tfs"]
        w = idf[safe_ids] * tfs * k1p1 / (tfs + denom[:n_docs, None])
        term_weights[:n_docs] = np.where(valid_slots, w, 0.0)

    pw = _fold_posting_weights(
        postings_doc, postings_tf, int(offsets[-1]), stored_df_i32.astype(np.int64),
        idf, denom, n_pad, k1p1,
    )
    return BM25Index(
        offsets=offsets.astype(np.int32),
        lengths=stored_df_i32,
        postings_doc=postings_doc,
        postings_tf=postings_tf,
        postings_weight=pw,
        term_ids=term_ids,
        term_weights=term_weights,
        contrib_denom_k1=denom,
        idf=idf,
        n_docs=n_docs,
        n_pad=n_pad,
        l_max=l_max,
        vocab=vocab,
        overflow_docs=res["overflow_docs"],
        config=config,
    )


# ---------------------------------------------------------------- staged channel


def _n_docs(state) -> int:
    n_docs = getattr(state, "n_docs", None)  # a PlacedLexical knows it
    if n_docs is not None:
        return n_docs
    return len(state.corpus) if state.corpus is not None else state.n_pad


def lexical_scores(
    state, query_terms: torch.Tensor, backend: Optional[str] = None
) -> torch.Tensor:
    """Dense f32[n_pad] BM25 scores of one padded query-term vector over the placed
    state (the reference's ``BM25Index.score``): ``"postings"`` adds the CSR windows
    term at a time, ``"termtable"`` launches the term-table kernel on CUDA; under
    ``"auto"`` corpora below :data:`AUTO_SORTED_DOCS` documents take the postings.
    ``backend`` defaults to the state's config's."""
    backend = backend or state.config.lexical_backend
    if backend == "auto":
        backend = "termtable" if _n_docs(state) >= AUTO_SORTED_DOCS else "postings"
    if backend == "postings" and state.lex_offsets is not None:
        return score_postings_pre(
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
    """Sort-based sparse top-k of one padded query-term vector (the reference's
    ``BM25Index.search_sorted``): (ids i64[top_k], scores f32[top_k]), O(matched
    postings). Every slot, in slot order, goes to the large tier of
    :func:`~triple_hybrid_rag_tpu_torch.ops.bm25.score_postings_topk_tiered` at
    window ``l_max``, so each term's stored postings are gathered exactly into one
    flat array, where the reference's windowed op reads ``l_max`` a slot; the ids and
    score bits are the reference's. The entries count in ``rag_metrics``'
    ``bm25_tiered_entries_total{path="staged"}``."""
    slots = torch.arange(query_terms.shape[0], device=query_terms.device)
    return score_postings_topk_tiered(
        state.lex_offsets, state.lex_lengths, state.lex_pd, state.lex_pt,
        query_terms[:0], slots[:0], query_terms, slots, row_mask,
        l_small=0, l_max=state.lex_l_max, n_pad=state.n_pad, top_k=top_k,
        entries_path="staged",
    )
