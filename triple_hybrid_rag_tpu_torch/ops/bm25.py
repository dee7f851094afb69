"""BM25 on the device: the lexical channel's two layouts.

The port of the JAX package's ``ops/bm25.py`` query ops, batched over a leading query
axis.

**Doc-major term table** (:func:`score_termtable_batch`): each document row holds its
unique terms ``term_ids[N, L]`` and their precomputed BM25 contributions
``term_weights[N, L]``; a query is a membership test,
``score[b, n] = sum_l w[n, l] * [ids[n, l] in query[b]]``. On a CUDA tensor this is the
hand-written kernel ``csrc/termtable.cu`` (the port of the Pallas kernel
``ops/pallas/lexical_kernel.py``), on a CPU tensor :func:`score_termtable_batch_plain`.

**CSR postings, term at a time** (:func:`score_postings`): one query's dense score
vector, each query slot's postings window added in slot order (the staged
retriever's ``"postings"`` backend).

**Sorted CSR postings** (:func:`score_postings_topk_pre`, ``_tiered``): work is
O(matched postings), independent of corpus size:

1. gather each query term's postings window (contiguous slices of precomputed
   per-posting BM25 weights),
2. sort the (doc, query-slot) pairs,
3. reduce each run of equal docs with a segmented *doubling* tree,
4. top-k over the run totals.

The doubling tree is kept in the reference's order on purpose: a run's total depends
only on run-relative offsets, so every score is bit-identical to the JAX op (the
property the reference's sharding proofs rest on). A ``scatter_add``/``index_add_``
over the whole sort would sum in another order and is deliberately not used there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .topk import NEG_INF, lax_top_k

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
    from ..kernels.build import check, load

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
    err = getattr(load("termtable"), fn)(
        ids.data_ptr(), w.data_ptr(), qt.data_ptr(), out.data_ptr(), n, width, b, q,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, fn)
    score_termtable_batch.launches += 1
    return out


def score_termtable_batch(
    term_ids: torch.Tensor,  # i32[N, L]
    term_weights: torch.Tensor,  # f32|bf16[N, L]
    query_terms: torch.Tensor,  # i32[B, Q]
) -> torch.Tensor:
    """Doc-major membership scoring, f32[B, N]: the CUDA kernel on a CUDA tensor (or
    raise), the plain version on a CPU tensor. The kernel reads the table once per
    128 queries and looks every slot up once, in a hash of those queries' terms.
    Sums run over the table's slots in another order than the reference's reduce,
    so scores agree to rounding, not bit for bit."""
    if term_ids.device.type == "cuda":
        return _launch_termtable(term_ids, term_weights, query_terms)
    return score_termtable_batch_plain(term_ids, term_weights, query_terms)


score_termtable_batch.launches = 0  # kernel launches (CUDA tensors only)


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


def score_postings(
    offsets: torch.Tensor,  # i32[V + 1] CSR offsets
    lengths: torch.Tensor,  # i32[V] stored df
    postings_doc: torch.Tensor,  # i32[nnz_pad] doc row per posting
    postings_weight: torch.Tensor,  # f32[nnz_pad] precomputed contribution
    query_terms: torch.Tensor,  # i[Q] padded query term ids (-1 = empty slot)
    *,
    l_max: int,
    n_pad: int,
) -> torch.Tensor:
    """Term-at-a-time CSR scoring of one query: dense f32[n_pad] BM25 scores (the
    reference's ``score_postings``). Each query slot adds its window's weights into
    the score vector in slot order, as the reference's loop of scatters does; a
    term's postings name each doc once, so every doc's sum runs over the slots in
    order and the scores are the reference's bits. Invalid postings go to a spill
    slot past ``n_pad`` that is dropped."""
    docs, contrib = gather_windows(
        offsets, lengths, postings_doc, postings_weight, query_terms[None, :], l_max, n_pad
    )
    scores = torch.zeros((n_pad + 1,), dtype=torch.float32, device=docs.device)
    for q in range(docs.shape[1]):
        scores.index_add_(0, docs[0, q], contrib[0, q])
    return scores[:n_pad]


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


def score_postings_topk_pre(
    offsets: torch.Tensor,
    lengths: torch.Tensor,
    postings_doc: torch.Tensor,
    postings_weight: torch.Tensor,
    query_terms: torch.Tensor,  # i[B, Q]
    row_mask: Optional[torch.Tensor] = None,  # bool[B, n_pad]
    *,
    l_max: int,
    n_pad: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched sparse BM25 top-k with one ``l_max`` window per query slot."""
    b, q = query_terms.shape
    docs, contrib = gather_windows(
        offsets, lengths, postings_doc, postings_weight, query_terms, l_max, n_pad
    )
    slots = torch.arange(q, device=docs.device)[None, :, None].expand(b, q, l_max)
    return sparse_topk_from_windows(
        docs.reshape(b, -1), slots.reshape(b, -1), contrib.reshape(b, -1),
        q, n_pad, top_k, row_mask,
    )


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """df-tiered variant: rare terms read ``l_small`` windows, the few large-tier
    slots read ``l_max``. The sort's secondary key is the ORIGINAL query slot, so
    the summation order (and every ulp) matches the untiered op."""
    b = small_terms.shape[0]
    ws = min(l_small, l_max)
    ds, cs = gather_windows(
        offsets, lengths, postings_doc, postings_weight, small_terms, ws, n_pad
    )
    dl, cl = gather_windows(
        offsets, lengths, postings_doc, postings_weight, large_terms, l_max, n_pad
    )
    ss = small_slots.long()[:, :, None].expand(-1, -1, ws)
    sl = large_slots.long()[:, :, None].expand(-1, -1, l_max)
    docs = torch.cat([ds.reshape(b, -1), dl.reshape(b, -1)], 1)
    slots = torch.cat([ss.reshape(b, -1), sl.reshape(b, -1)], 1)
    contribs = torch.cat([cs.reshape(b, -1), cl.reshape(b, -1)], 1)
    q_slots = int(small_terms.shape[1] + large_terms.shape[1])
    return sparse_topk_from_windows(
        docs, slots, contribs, q_slots, n_pad, top_k, row_mask
    )
