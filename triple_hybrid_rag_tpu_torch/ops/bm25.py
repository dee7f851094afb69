"""BM25 on the device: the lexical channel's two layouts.

The port of the JAX package's ``ops/bm25.py`` query ops, batched over a leading query
axis.

**Doc-major term table** (:func:`score_termtable_batch`): each document row holds its
unique terms ``term_ids[N, L]`` and their precomputed BM25 contributions
``term_weights[N, L]``; a query is a membership test,
``score[b, n] = sum_l w[n, l] * [ids[n, l] in query[b]]``. On a CUDA tensor this is the
hand-written kernel ``csrc/termtable.cu`` (the port of the Pallas kernel
``ops/pallas/lexical_kernel.py``), on a CPU tensor :func:`score_termtable_batch_plain`.

**CSR postings, term at a time** (:func:`score_postings_pre`): one query's dense
score vector, each query slot's postings window of precomputed weights added in
slot order (the staged retriever's ``"postings"`` backend). :func:`score_postings`
is the reference's form of the same op: it computes each posting's contribution
``idf * tf * (k1 + 1) / (tf + denom)`` from the term frequencies as it goes.

**Sorted CSR postings** (:func:`score_postings_topk_pre`, ``_tiered``, and the
reference's :func:`score_postings_topk` over term frequencies), independent of
corpus size:

1. gather each query term's postings (contiguous slices of the per-posting BM25
   weights),
2. sort the (doc, query-slot) pairs,
3. reduce each run of equal docs with a segmented *doubling* tree,
4. top-k over the run totals.

Only :func:`score_postings_topk_tiered` does work O(matched postings): it gathers
each slot's valid postings exactly, into one flat array. It is the batched program's
lexical stage, and the staged channel's (``index/bm25_index.lexical_search_sorted``,
behind ``Retriever.retrieve`` and ``BM25Index.search_sorted``: every slot of the one
query in its large tier). :func:`score_postings_topk_pre` and
:func:`score_postings_topk` gather a fixed window per query slot (``l_max`` wide),
whatever the term's df: the engine's ``lexical_tiering=False`` form and the reference's.

The doubling tree is kept in the reference's order on purpose: a run's total depends
only on run-relative offsets, so every score is bit-identical to the JAX op (the
property the reference's sharding proofs rest on). A ``scatter_add``/``index_add_``
over the whole sort would sum in another order and is deliberately not used there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..observability import rag_metrics
from .topk import NEG_INF, _float_order_key, lax_top_k

__all__ = ["score_postings", "score_termtable", "QUERY_PAD", "DOC_PAD"]

QUERY_PAD = -1  # query slot sentinel (also the OOV term id)
DOC_PAD = -2  # term-table pad sentinel; distinct from QUERY_PAD so pads never match
# query slots the kernel takes: its membership table of a block of 128 queries
# (2 * 128 * Q entries of 20 bytes) must fit the shared memory of one SM
_MAX_QUERY_TERMS = 32


def bm25_idf(n_docs, df: torch.Tensor) -> torch.Tensor:
    """Okapi BM25 idf with the +1 smoothing that keeps it positive."""
    return torch.log1p((n_docs - df + 0.5) / (df + 0.5))


def bm25_denom_k1(
    doc_lengths: torch.Tensor, avgdl: torch.Tensor, k1: float, b: float
) -> torch.Tensor:
    """Per-document ``k1 * (1 - b + b * dl / avgdl)``."""
    return k1 * (1.0 - b + b * doc_lengths / torch.clamp(avgdl, min=1e-6))


def score_termtable_batch_plain(
    term_ids: torch.Tensor,  # i32[N, L] unique terms per doc (DOC_PAD = empty slot)
    term_weights: torch.Tensor,  # f32|bf16[N, L] precomputed contribution per (doc, term)
    query_terms: torch.Tensor,  # i32[B, Q] padded query term ids (QUERY_PAD = empty slot)
) -> torch.Tensor:
    """Plain PyTorch version of the term-table kernel: f32[B, N] BM25 scores."""
    w = term_weights.float()
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    out = torch.empty(
        (query_terms.shape[0], term_ids.shape[0]), dtype=torch.float32, device=w.device
    )
    for i, q in enumerate(query_terms.to(term_ids.dtype)):
        match = torch.zeros_like(term_ids, dtype=torch.bool)
        for t in q:  # one [N, L] compare per query slot: no [N, L, Q] intermediate
            match |= term_ids == t
        out[i] = torch.where(match, w, zero).sum(dim=1)
    return out


def _launch_termtable(term_ids, term_weights, query_terms):
    from ..kernels.build import launch

    n, width = term_ids.shape
    b, q = query_terms.shape
    if term_weights.shape != (n, width):
        raise ValueError("term_weights must have the term table's shape")
    if term_weights.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported weight dtype {term_weights.dtype}")
    if width < 1 or q > _MAX_QUERY_TERMS:
        raise ValueError(
            f"the kernel takes tables at least 1 wide and queries up to "
            f"{_MAX_QUERY_TERMS} terms, got {width} and {q}"
        )
    dev = term_ids.device
    ids = term_ids.to(torch.int32).contiguous()
    w = term_weights.contiguous()
    qt = query_terms.to(torch.int32).contiguous()
    if w.device != dev or qt.device != dev:
        raise ValueError("all inputs must be on the term table's device")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b * n * q == 0:
        return out.zero_()
    fn = "termtable_scores_bf16" if w.dtype == torch.bfloat16 else "termtable_scores_f32"
    launch("termtable", fn, dev, ids.data_ptr(), w.data_ptr(), qt.data_ptr(), out.data_ptr(),
           n, width, b, q)
    return out


def score_termtable_batch(
    term_ids: torch.Tensor,  # i32[N, L]
    term_weights: torch.Tensor,  # f32|bf16[N, L]
    query_terms_batch: torch.Tensor,  # i32[B, Q]
) -> torch.Tensor:
    """Doc-major membership scoring, f32[B, N]: the CUDA kernel on a CUDA tensor (or
    raise), the plain version on a CPU tensor. The kernel reads the table once per
    128 queries and looks every slot up once, in a hash of those queries' terms.
    Sums run over the table's slots in another order than the reference's reduce,
    so scores agree to rounding, not bit for bit."""
    if term_ids.device.type == "cuda":
        return _launch_termtable(term_ids, term_weights, query_terms_batch)
    return score_termtable_batch_plain(term_ids, term_weights, query_terms_batch)


def score_termtable(
    term_ids: torch.Tensor, term_weights: torch.Tensor, query_terms: torch.Tensor  # i32[Q]
) -> torch.Tensor:
    """One query against the term table: f32[N]."""
    return score_termtable_batch(term_ids, term_weights, query_terms[None, :])[0]


def gather_windows(
    offsets: torch.Tensor,   # i32[V + 1] CSR offsets
    lengths: torch.Tensor,   # i32[V] stored df
    postings_doc: torch.Tensor,     # i32[nnz_pad] doc row per posting
    postings_weight: torch.Tensor,  # f32[nnz_pad] precomputed contribution
    terms: torch.Tensor,     # i[B, Q] term ids (-1 = empty slot)
    window: int,
    n_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(docs i64[B, Q, window], contrib f32[B, Q, window]); invalid slots hold doc
    ``n_pad`` (sorts last) and contribution 0."""
    terms = terms.long()
    valid_t = terms >= 0
    t = torch.where(valid_t, terms, torch.zeros_like(terms))
    # dynamic_slice semantics: the start clamps so the window stays in bounds
    start = offsets.long()[t].clamp(0, postings_doc.shape[0] - window)
    df = lengths.long()[t]
    pos = torch.arange(window, device=terms.device)
    idx = start[..., None] + pos
    valid = (pos < df[..., None]) & valid_t[..., None]
    docs = torch.where(valid, postings_doc.long()[idx], torch.full_like(idx, n_pad))
    contrib = torch.where(
        valid, postings_weight.float()[idx], torch.zeros((), device=terms.device)
    )
    return docs, contrib


def score_postings_pre(
    offsets: torch.Tensor,  # i32[V + 1] CSR offsets
    lengths: torch.Tensor,  # i32[V] stored df
    postings_doc: torch.Tensor,  # i32[nnz_pad] doc row per posting
    postings_weight: torch.Tensor,  # f32[nnz_pad] precomputed contribution
    query_terms: torch.Tensor,  # i[Q] padded query term ids (-1 = empty slot)
    *,
    l_max: int,
    n_pad: int,
) -> torch.Tensor:
    """Term-at-a-time CSR scoring of one query over precomputed per-posting
    weights: dense f32[n_pad] BM25 scores. Each query slot adds its window's
    weights into the score vector in slot order, as the reference's loop of
    scatters does; a term's postings name each doc once, so every doc's sum runs
    over the slots in order and the scores are the reference's bits. Invalid
    postings go to a spill slot past ``n_pad`` that is dropped."""
    docs, contrib = gather_windows(
        offsets, lengths, postings_doc, postings_weight, query_terms[None, :], l_max, n_pad
    )
    return _add_windows(docs[0], contrib[0], n_pad)


def _add_windows(docs: torch.Tensor, contrib: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Each slot's window [Q, W] added into f32[n_pad + 1] in slot order; the
    spill slot ``n_pad`` is dropped."""
    scores = torch.zeros((n_pad + 1,), dtype=torch.float32, device=docs.device)
    for q in range(docs.shape[0]):
        scores.index_add_(0, docs[q], contrib[q])
    return scores[:n_pad]


def posting_contributions(
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    postings_doc: torch.Tensor,
    postings_tf: torch.Tensor,  # f32[nnz_pad] term frequency per posting
    contrib_denom_k1: torch.Tensor,  # f32[n_pad] per-doc k1 * (1 - b + b * dl / avgdl)
    idf: torch.Tensor,  # f32[V]
    k1_plus1,  # f32 scalar k1 + 1
    terms: torch.Tensor,  # i[B, Q] term ids (-1 = empty slot)
    window: int,
    n_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(docs i64[B, Q, window], contrib f32[B, Q, window]) with each posting's
    contribution ``idf[t] * tf * (k1 + 1) / (tf + denom[doc])`` computed in the
    reference's order of operations (f32 throughout); invalid slots hold doc
    ``n_pad`` and contribution 0, as :func:`gather_windows`."""
    docs, tfs = gather_windows(offsets, lengths, postings_doc, postings_tf, terms, window, n_pad)
    t = terms.long()
    term_idf = idf.float()[torch.where(t >= 0, t, torch.zeros_like(t))]  # [B, Q]
    denom = contrib_denom_k1.float()[docs.clamp(0, n_pad - 1)]
    k1p1 = torch.as_tensor(k1_plus1, dtype=torch.float32, device=tfs.device)
    contrib = term_idf[..., None] * tfs * k1p1 / (tfs + denom)
    return docs, torch.where(docs < n_pad, contrib, torch.zeros((), device=tfs.device))


def score_postings(
    offsets: torch.Tensor,  # i32[V + 1] CSR offsets
    lengths: torch.Tensor,  # i32[V] stored df
    postings_doc: torch.Tensor,  # i32[nnz_pad] doc row per posting
    postings_tf: torch.Tensor,  # f32[nnz_pad] term frequency per posting
    contrib_denom_k1: torch.Tensor,  # f32[n_pad] per-doc k1 * (1 - b + b * dl / avgdl)
    idf: torch.Tensor,  # f32[V]
    k1_plus1,  # f32 scalar k1 + 1
    query_terms: torch.Tensor,  # i[Q] padded query term ids (-1 = empty slot)
    *,
    l_max: int,
    n_pad: int,
) -> torch.Tensor:
    """Term-at-a-time CSR scoring of one query, the reference's ``score_postings``:
    dense f32[n_pad] BM25 scores with each posting's contribution computed from its
    term frequency (:func:`posting_contributions`), added slot by slot as
    :func:`score_postings_pre` adds precomputed weights."""
    docs, contrib = posting_contributions(
        offsets, lengths, postings_doc, postings_tf, contrib_denom_k1, idf, k1_plus1,
        query_terms[None, :], l_max, n_pad,
    )
    return _add_windows(docs[0], contrib[0], n_pad)


def sparse_topk_from_windows(
    docs: torch.Tensor,      # i64[B, P]
    slots: torch.Tensor,     # i64[B, P] query slot of each entry
    contribs: torch.Tensor,  # f32[B, P]
    q_slots: int,
    n_pad: int,
    top_k: int,
    row_mask: Optional[torch.Tensor] = None,  # bool[B, n_pad]
    combine: str = "sum",
    run_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared tail: (doc, slot) sort, segmented doubling reduction, top-k over run
    starts. ``combine`` is "sum" (BM25) or "max" (graph best-entity);
    ``run_bound`` caps the doubling depth when runs are known to be shorter than
    ``q_slots``."""
    b, p = docs.shape
    key = (docs.long() << 32) | slots.long()
    perm = torch.argsort(key, dim=1, stable=True)
    sorted_docs = torch.gather(docs.long(), 1, perm)
    acc = torch.gather(contribs.float(), 1, perm)

    # after step s, acc[i] = reduction of run elements in [i, i + 2^s)
    step = 1
    bound = q_slots if run_bound is None else min(run_bound, q_slots)
    while step < bound:
        shifted_acc = torch.cat([acc[:, step:], acc.new_zeros((b, min(step, p)))], 1)[:, :p]
        shifted_doc = torch.cat(
            [sorted_docs[:, step:], sorted_docs.new_full((b, min(step, p)), -9)], 1
        )[:, :p]
        same = shifted_doc == sorted_docs
        if combine == "max":
            acc = torch.maximum(acc, shifted_acc.masked_fill(~same, NEG_INF))
        else:
            acc = acc + shifted_acc.masked_fill(~same, 0.0)
        step <<= 1

    prev_docs = torch.cat([sorted_docs.new_full((b, 1), -9), sorted_docs[:, :-1]], 1)
    ok_row = (sorted_docs != prev_docs) & (sorted_docs < n_pad)
    if row_mask is not None:
        ok_row = ok_row & torch.gather(row_mask, 1, sorted_docs.clamp(0, n_pad - 1))
    score_at_start = acc.masked_fill(~ok_row, NEG_INF)
    kk = min(top_k, p)
    vals, pos = lax_top_k(score_at_start, kk)
    ok = vals > NEG_INF
    ids = torch.where(ok, torch.gather(sorted_docs, 1, pos), torch.full_like(pos, -1))
    vals = vals.masked_fill(~ok, NEG_INF)
    if kk < top_k:
        ids = torch.cat([ids, ids.new_full((b, top_k - kk), -1)], 1)
        vals = torch.cat([vals, vals.new_full((b, top_k - kk), NEG_INF)], 1)
    return ids, vals


def _as_batch(query_terms: torch.Tensor, row_mask: Optional[torch.Tensor]):
    """(single, terms i[B, Q], mask bool[B, n_pad] or None): the reference's one
    query i[Q] (with a bool[n_pad] mask) as a batch of one."""
    if query_terms.dim() != 1:
        return False, query_terms, row_mask
    return True, query_terms[None, :], None if row_mask is None else row_mask[None, :]


def _window_topk(single: bool, docs, contrib, n_pad: int, top_k: int, row_mask):
    """The sorted top-k over windows [B, Q, W] whose slot is their Q index; one
    query's row alone when ``single``."""
    b, q, w = docs.shape
    slots = torch.arange(q, device=docs.device)[None, :, None].expand(b, q, w)
    ids, vals = sparse_topk_from_windows(
        docs.reshape(b, -1), slots.reshape(b, -1), contrib.reshape(b, -1),
        q, n_pad, top_k, row_mask,
    )
    return (ids[0], vals[0]) if single else (ids, vals)


def score_postings_topk_pre(
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    postings_doc: torch.Tensor,
    postings_weight: torch.Tensor,
    query_terms: torch.Tensor,  # i[B, Q], or the reference's one query i[Q]
    row_mask: Optional[torch.Tensor] = None,  # bool[B, n_pad], or bool[n_pad]
    *,
    l_max: int,
    n_pad: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched sparse BM25 top-k with one ``l_max`` window per query slot: (ids
    i64[B, top_k], scores f32[B, top_k]); one query i[Q] gives [top_k], as the
    reference's op."""
    single, query_terms, row_mask = _as_batch(query_terms, row_mask)
    docs, contrib = gather_windows(
        offsets, lengths, postings_doc, postings_weight, query_terms, l_max, n_pad
    )
    return _window_topk(single, docs, contrib, n_pad, top_k, row_mask)


def score_postings_topk(
    offsets: torch.Tensor,  # i32[V + 1]
    lengths: torch.Tensor,  # i32[V]
    postings_doc: torch.Tensor,  # i32[nnz_pad]
    postings_tf: torch.Tensor,  # f32[nnz_pad]
    contrib_denom_k1: torch.Tensor,  # f32[n_pad]
    idf: torch.Tensor,  # f32[V]
    k1_plus1,  # f32 scalar k1 + 1
    query_terms: torch.Tensor,  # i[Q], or i[B, Q]
    row_mask: Optional[torch.Tensor] = None,  # bool[n_pad], or bool[B, n_pad]
    *,
    l_max: int,
    n_pad: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's sparse BM25 top-k over term frequencies: (ids i64[top_k],
    scores f32[top_k]), -1 / -inf in empty slots. The contributions are
    :func:`posting_contributions`; the sort, the doubling tree and the top-k are
    :func:`score_postings_topk_pre`'s, so the scores are the reference's bits. A
    query batch i[B, Q] (with a bool[B, n_pad] mask) gives [B, top_k]."""
    single, query_terms, row_mask = _as_batch(query_terms, row_mask)
    docs, contrib = posting_contributions(
        offsets, lengths, postings_doc, postings_tf, contrib_denom_k1, idf, k1_plus1,
        query_terms, l_max, n_pad,
    )
    return _window_topk(single, docs, contrib, n_pad, top_k, row_mask)


def _flat_run_totals(run: torch.Tensor, acc: torch.Tensor, bound: int) -> torch.Tensor:
    """The segmented doubling sum of :func:`sparse_topk_from_windows` over one flat
    sorted array: entries with equal ``run`` ids are one run; at each run's start
    the result is the run's total, summed in the reference's order."""
    p = acc.shape[0]
    step = 1
    while step < bound:
        shifted_acc = torch.cat([acc[step:], acc.new_zeros(min(step, p))])[:p]
        shifted_run = torch.cat([run[step:], run.new_full((min(step, p),), -9)])[:p]
        acc = acc + shifted_acc.masked_fill(shifted_run != run, 0.0)
        step <<= 1
    return acc


def score_postings_topk_tiered(
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    postings_doc: torch.Tensor,
    postings_weight: torch.Tensor,
    small_terms: torch.Tensor,  # i[B, Qs] terms with stored df <= l_small (-1 pad)
    small_slots: torch.Tensor,  # i[B, Qs] original query slot of each small term
    large_terms: torch.Tensor,  # i[B, Ql] high-df terms (-1 pad)
    large_slots: torch.Tensor,  # i[B, Ql]
    row_mask: Optional[torch.Tensor] = None,
    *,
    l_small: int,
    l_max: int,
    n_pad: int,
    top_k: int,
    entries_path: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """df-tiered sparse BM25 top-k: (ids i64[B, top_k], scores f32[B, top_k]); one
    query (1-D term and slot arrays, as the reference's op takes) gives [top_k].

    The reference gathers an ``l_small`` window for each small-tier slot and an
    ``l_max`` window for each large-tier slot, whatever the term's df. Here each
    slot reads exactly the ``min(df, window)`` postings the window holds valid,
    into one flat array of per-query segments, so the work is O(matched postings).
    Its size is the one host read of the call. The entries are sorted once by
    (query, doc, original slot), packed into int32 when the sizes fit; the
    reference's doubling tree sums each (query, doc) run, and each query's run
    starts are ranked by score, then doc, as ``lax_top_k`` ranks them. A run's
    total depends only on run-relative offsets, so the ids and every score bit are
    the reference's. One query (B = 1) takes :func:`_tiered_one_query`, which gives
    the same bits with fewer operations. ``rag_metrics``' ``bm25_tiered_entries_total``
    counts the flat entries sorted: in its unlabelled series, or in the one labelled
    ``path=entries_path``."""
    single, small_terms, row_mask = _as_batch(small_terms, row_mask)
    if single:
        small_slots, large_terms, large_slots = (
            x[None, :] for x in (small_slots, large_terms, large_slots))
    dev = small_terms.device
    b, qs = small_terms.shape
    if b == 1:
        windows = [min(l_small, l_max)] * qs + [l_max] * large_terms.shape[1]
        ids, vals = _tiered_one_query(
            offsets, lengths, postings_doc, postings_weight,
            torch.cat([small_terms[0], large_terms[0]]),
            torch.cat([small_slots[0], large_slots[0]]), windows,
            None if row_mask is None else row_mask[0], top_k, entries_path)
        return (ids, vals) if single else (ids[None], vals[None])
    # columns in the reference's order: the small slots, then the large ones
    terms = torch.cat([small_terms, large_terms], 1).long()
    slots = torch.cat([small_slots, large_slots], 1).long()
    c = terms.shape[1]
    window = torch.full((c,), l_max, dtype=torch.long, device=dev)
    window[:qs] = min(l_small, l_max)
    valid = terms >= 0
    t = torch.where(valid, terms, torch.zeros_like(terms))
    # gather_windows' clamp: the window stays inside the postings
    start = torch.minimum(offsets[t].long().clamp(min=0), postings_doc.shape[0] - window)
    count = torch.where(valid, torch.minimum(lengths[t].long(), window).clamp(min=0), 0)
    total = int(count.sum())  # the one host read: the flat array's size
    _count_entries(total, entries_path)
    if total == 0:
        ids = torch.full((b, top_k), -1, dtype=torch.long, device=dev)
        vals = torch.full((b, top_k), NEG_INF, dtype=torch.float32, device=dev)
        return (ids[0], vals[0]) if single else (ids, vals)

    # the flat gather: entry e of segment (query, column) reads start + e - seg_start
    seg_len = count.reshape(-1)
    seg_start = seg_len.cumsum(0) - seg_len
    seg = torch.repeat_interleave(
        torch.arange(b * c, device=dev), seg_len, output_size=total)
    idx = start.reshape(-1)[seg] + torch.arange(total, device=dev) - seg_start[seg]
    docs = postings_doc[idx].long()
    contrib = postings_weight[idx].float()
    # each column's rank by (original slot, column) within its query: the order the
    # reference's (doc, slot) sort leaves a doc's entries in
    col = torch.arange(c, device=dev)
    earlier = (slots[:, None, :] < slots[:, :, None]) | (
        (slots[:, None, :] == slots[:, :, None]) & (col[None, :] < col[:, None]))
    rank = earlier.sum(-1).reshape(-1)[seg]
    run = (seg // c) * n_pad + docs  # (query, doc)
    key = run * c + rank
    if b * n_pad * c <= 2**32:  # radix passes scale with the key's bits
        key = (key - 2**31).to(torch.int32)
    perm = torch.sort(key, stable=True).indices
    run = run[perm]
    acc = _flat_run_totals(run, contrib[perm], c)

    ok = torch.ones_like(run, dtype=torch.bool)
    ok[1:] = run[1:] != run[:-1]  # run starts
    query, doc = run // n_pad, run % n_pad
    if row_mask is not None:
        ok &= row_mask[query, doc]
    score = acc.masked_fill(~ok, NEG_INF)
    # per query: score descending, then position (doc) ascending, as lax_top_k
    desc = (2**31 - 1) - _float_order_key(score)
    perm = torch.sort(query * 2**32 + desc, stable=True).indices
    score, doc = score[perm], doc[perm]

    q_len = count.sum(1)
    pos = (q_len.cumsum(0) - q_len)[:, None] + torch.arange(top_k, device=dev)
    have = torch.arange(top_k, device=dev)[None, :] < q_len[:, None]
    pos = pos.clamp(max=total - 1)
    found = have & (score[pos] > NEG_INF)
    ids = torch.where(found, doc[pos], -1)
    vals = torch.where(found, score[pos], NEG_INF)
    return (ids[0], vals[0]) if single else (ids, vals)


def _count_entries(total: int, path: Optional[str]) -> None:
    rag_metrics.counter("bm25_tiered_entries_total").inc(
        total, None if path is None else {"path": path})


def _tiered_one_query(
    offsets, lengths, postings_doc, postings_weight,
    terms: torch.Tensor,  # i[C] the query's columns: its small slots, then its large
    slots: torch.Tensor,  # i[C] each column's original query slot
    windows,  # each column's window
    row_mask: Optional[torch.Tensor],  # bool[n_pad]
    top_k: int,
    entries_path: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`score_postings_topk_tiered` of one query: (ids i64[top_k], scores
    f32[top_k]). One host read brings each column's term, slot, postings start and
    stored df. The columns' valid postings are concatenated in (original slot,
    column) order, so a stable sort by doc alone leaves each doc's entries in the
    order the batched key (query, doc, slot rank) leaves them, and the run starts in
    doc order: ``lax_top_k``'s (score, then position) is the batched (score, then
    doc). The doubling tree is the batched one, so the bits are too."""
    safe = terms.long().clamp(min=0)
    term, slot, start, df = torch.stack(
        [terms.long(), slots.long(), offsets[safe].long(), lengths[safe].long()]).tolist()
    spans = []
    for j in sorted(range(len(windows)), key=lambda j: (slot[j], j)):
        n = min(max(df[j], 0), windows[j])
        if term[j] >= 0 and n:  # gather_windows' clamp keeps the window in the postings
            s = min(max(start[j], 0), postings_doc.shape[0] - windows[j])
            spans.append(slice(s, s + n))
    total = sum(x.stop - x.start for x in spans)
    _count_entries(total, entries_path)
    dev = terms.device
    if total == 0:
        return (torch.full((top_k,), -1, dtype=torch.long, device=dev),
                torch.full((top_k,), NEG_INF, dtype=torch.float32, device=dev))
    docs, perm = torch.sort(torch.cat([postings_doc[x] for x in spans]), stable=True)
    contrib = torch.cat([postings_weight[x] for x in spans]).float()[perm]
    acc = _flat_run_totals(docs, contrib, len(windows))
    ok = torch.ones_like(docs, dtype=torch.bool)
    ok[1:] = docs[1:] != docs[:-1]  # run starts
    if row_mask is not None:
        ok &= row_mask[docs]
    kk = min(top_k, total)
    vals, pos = lax_top_k(acc.masked_fill(~ok, NEG_INF), kk)
    found = vals > NEG_INF
    ids = torch.where(found, docs[pos].long(), -1)
    if kk < top_k:
        ids = torch.cat([ids, ids.new_full((top_k - kk,), -1)])
        vals = torch.cat([vals, vals.new_full((top_k - kk,), NEG_INF)])
    return ids, vals
