"""The port's sorted-postings BM25 top-k against the JAX ops on a random CSR:
ids and scores bit-equal (the doubling reduction keeps the reference's order)."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from triple_hybrid_rag_tpu.ops import bm25 as ref
from triple_hybrid_rag_tpu_torch.index.bm25_index import lexical_search_sorted
from triple_hybrid_rag_tpu_torch.observability import rag_metrics
from triple_hybrid_rag_tpu_torch.ops import bm25 as port


def _csr(rng, n_docs=300, vocab=60, l_max=40):
    """Term-major CSR with doc-ascending postings, tail-padded by l_max."""
    offsets, docs, weights = [0], [], []
    lengths = []
    for _ in range(vocab):
        df = int(rng.integers(0, l_max + 1))
        d = np.sort(rng.choice(n_docs, size=df, replace=False))
        docs.extend(d)
        weights.extend(rng.random(df).astype(np.float32) * 3)
        lengths.append(df)
        offsets.append(offsets[-1] + df)
    docs = np.array(docs + [-1] * l_max, np.int32)
    weights = np.array(weights + [0.0] * l_max, np.float32)
    return (np.array(offsets, np.int32), np.array(lengths, np.int32), docs, weights)


def _queries(rng, b, q, vocab):
    terms = np.full((b, q), -1, np.int32)
    for i in range(b):
        k = int(rng.integers(0, q + 1))
        terms[i, :k] = rng.choice(vocab, size=k, replace=False)
    return terms


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bit_equal(ref_out, got):
    r_ids, r_vals = (np.asarray(x) for x in ref_out)
    np.testing.assert_array_equal(r_ids, got[0].numpy())
    np.testing.assert_array_equal(r_vals.view(np.int32), got[1].numpy().view(np.int32))


@pytest.mark.parametrize("scoped", [False, True])
def test_pre_bit_equal(rng, scoped):
    n_pad, l_max, top_k, b = 320, 40, 12, 5
    csr = _csr(rng)
    terms = _queries(rng, b, 8, 60)
    masks = rng.random((b, n_pad)) > 0.4 if scoped else None
    want = jax.vmap(
        lambda qt, m: ref.score_postings_topk_pre(
            *map(jnp.asarray, csr), qt, m, l_max=l_max, n_pad=n_pad, top_k=top_k),
        in_axes=(0, 0 if scoped else None),
    )(jnp.asarray(terms), jnp.asarray(masks) if scoped else None)
    got = port.score_postings_topk_pre(
        *map(_t, csr), _t(terms), _t(masks) if scoped else None,
        l_max=l_max, n_pad=n_pad, top_k=top_k,
    )
    _bit_equal(want, got)


def _tier(csr, rows, l_small, qs, ql):
    """The host's tiering of query rows (as ``encode_query_tiered``): terms with df
    <= l_small to the small tier, the rest to the large one, both with their
    original slots; at most ``qs`` / ``ql`` of each."""
    lengths = csr[1]
    tiers = [np.full((len(rows), w), -1, np.int32) for w in (qs, qs, ql, ql)]
    tiers[1][:] = tiers[3][:] = 0
    for i, row in enumerate(rows):
        small = [(t, s) for s, t in enumerate(row) if t >= 0 and lengths[t] <= l_small]
        large = [(t, s) for s, t in enumerate(row) if t >= 0 and lengths[t] > l_small]
        for (terms, slots), pairs in (((tiers[0], tiers[1]), small[:qs]),
                                      ((tiers[2], tiers[3]), large[:ql])):
            for j, (t, s) in enumerate(pairs):
                terms[i, j], slots[i, j] = t, s
    return tiers


def _skewed_csr(rng, n_docs=300, vocab=60, l_max=240):
    """A CSR whose dfs span 1..l_max (a few terms hold most postings), tail-padded."""
    dfs = np.maximum(1, (l_max * rng.random(vocab) ** 6).astype(int))
    dfs[:3] = (l_max, l_max // 2, 2)
    offsets, docs = [0], []
    for df in dfs:
        docs.extend(np.sort(rng.choice(n_docs, size=df, replace=False)))
        offsets.append(offsets[-1] + df)
    nnz = offsets[-1]
    weights = rng.random(nnz).astype(np.float32) * 3
    return (np.array(offsets, np.int32), dfs.astype(np.int32),
            np.array(docs + [-1] * l_max, np.int32),
            np.concatenate([weights, np.zeros(l_max, np.float32)]))


def _tiered_case(rng, case):
    """(csr, tiers, l_small, l_max, n_pad, top_k) of one case of the tiered op."""
    l_small, l_max, n_pad, top_k, b = 8, 40, 320, 200, 4
    csr = _csr(rng)
    rows = _queries(rng, b, 8, 60)
    if case == "skewed":  # large slots hold up to 120x another's postings
        l_max = 240
        csr = _skewed_csr(rng, l_max=l_max)
        rows = _queries(rng, b, 8, 60)
        rows[0, :3] = (0, 1, 2)
    elif case == "empty_query":  # one query without a valid slot
        rows[1] = -1
    elif case == "empty_batch":
        rows[:] = -1
    elif case == "few_entries":  # one term of df <= 40 each: top_k past the entries
        top_k = 50
        rows[:, 0] = rng.choice(60, size=b, replace=False)
        rows[:, 1:] = -1
    elif case == "equal_weights":  # every score ties: positions (docs) decide
        csr = csr[:3] + (np.where(csr[2] >= 0, 1.0, 0.0).astype(np.float32),)
        top_k = 30
    elif case == "long_runs":  # 11 kept slots over 10 docs: runs of 9 to 11 entries
        l_max = 10
        dfs = np.repeat([10, 9], 30)  # terms 0-29 every doc (large), 30-59 nine (small)
        docs = [np.sort(rng.choice(10, size=df, replace=False)) for df in dfs]
        csr = (np.concatenate([[0], np.cumsum(dfs)]).astype(np.int32), dfs.astype(np.int32),
               np.concatenate(docs + [np.full(10, -1)]).astype(np.int32),
               np.concatenate([rng.random(dfs.sum()) * 3, np.zeros(10)]).astype(np.float32))
        l_small = 9
        rows = np.stack([np.concatenate([rng.choice(30, 3, replace=False),
                                         30 + rng.choice(30, 8, replace=False)])
                         for _ in range(b)]).astype(np.int32)
    tiers = _tier(csr, rows, l_small, 8, 3)
    if case == "small_overflow":  # a small slot whose df passes l_small reads l_small
        long_terms = [t for t in range(60) if csr[1][t] > 2 * l_small]
        tiers[0][:, -1], tiers[1][:, -1] = long_terms[:b], 8
    elif case == "wide_keys":  # B * n_pad * slots past 32 bits: the int64 sort key
        n_pad = 2**30
    return csr, tiers, l_small, l_max, n_pad, top_k


TIERED_CASES = [
    ("random", False), ("random", True), ("skewed", False), ("skewed", True),
    ("empty_query", True), ("empty_batch", False), ("few_entries", False),
    ("equal_weights", False), ("equal_weights", True), ("small_overflow", False),
    ("long_runs", False), ("wide_keys", False), ("single", False), ("single", True),
]


@pytest.mark.parametrize(  # the random cases keep their ids, [False] and [True]
    "case,scoped",
    [pytest.param(c, m, id=str(m) if c == "random" else f"{c}-{m}") for c, m in TIERED_CASES])
def test_tiered_bit_equal(rng, case, scoped):
    """The exact flat gather against the reference's windowed op, ids and score
    bits; ``single`` is the reference's one-query form (1-D arrays)."""
    csr, tiers, l_small, l_max, n_pad, top_k = _tiered_case(rng, case)
    b = tiers[0].shape[0]
    masks = rng.random((b, n_pad)) > 0.4 if scoped else None
    shape = dict(l_small=l_small, l_max=l_max, n_pad=n_pad, top_k=top_k)
    if case == "single":
        tiers, masks = [x[0] for x in tiers], None if masks is None else masks[0]
        want = ref.score_postings_topk_tiered(
            *map(jnp.asarray, csr), *map(jnp.asarray, tiers),
            None if masks is None else jnp.asarray(masks), **shape)
    else:
        want = jax.vmap(
            lambda a, c, d, e, m: ref.score_postings_topk_tiered(
                *map(jnp.asarray, csr), a, c, d, e, m, **shape),
            in_axes=(0, 0, 0, 0, 0 if scoped else None),
        )(*map(jnp.asarray, tiers), jnp.asarray(masks) if scoped else None)
    entries = rag_metrics.counter("bm25_tiered_entries_total")
    before = entries.value()
    got = port.score_postings_topk_tiered(
        *map(_t, csr), *map(_t, tiers), _t(masks) if scoped else None, **shape)
    _bit_equal(want, got)
    assert got[0].shape == np.asarray(want[0]).shape
    df = csr[1]
    read = sum(min(int(df[t]), w) for terms, w in ((tiers[0], min(l_small, l_max)),
                                                    (tiers[2], l_max))
               for t in np.ravel(terms) if t >= 0)
    assert entries.value() - before == read
    if case == "empty_batch":
        assert read == 0 and (got[0] == -1).all()


STAGED_CASES = ("random", "df_l_max", "all_slots", "repeated_term", "oov_only",
                "few_matches", "equal_weights", "row_mask")


def _staged_case(rng, case):
    """(csr, one query i32[16], row mask bool[n_pad] or None, l_max, n_pad, top_k) of
    one case of the staged channel; term 0 holds ``l_max`` postings, term 2 two."""
    l_max, n_pad, top_k = 240, 320, 30
    csr = _skewed_csr(rng, l_max=l_max)
    query = np.full(16, -1, np.int32)
    query[:6] = rng.choice(60, size=6, replace=False)
    mask = None
    if case in ("df_l_max", "row_mask"):
        query[:3] = (0, 1, 2)
        if case == "row_mask":
            mask = rng.random(n_pad) > 0.4
    elif case == "all_slots":
        query[:] = rng.choice(60, size=16, replace=False)
    elif case == "repeated_term":  # one term in two slots: each of its docs twice
        query[:4] = (0, 7, 0, 9)
    elif case == "oov_only":
        query[:] = -1
    elif case == "few_matches":  # two matched docs against a top_k of 30
        query[:] = -1
        query[0] = 2
    elif case == "equal_weights":  # ties fall to doc order
        csr = csr[:3] + (np.where(csr[2] >= 0, 1.0, 0.0).astype(np.float32),)
        query[:3] = (0, 1, 5)
    return csr, query, mask, l_max, n_pad, top_k


@pytest.mark.parametrize("case", STAGED_CASES)
def test_staged_flat_bit_equal(rng, case):
    """The staged channel's sorted search of one query (every slot in the flat
    gather's large tier) against the reference's windowed op at one query: ids and
    score bits. Its entries count in the ``path="staged"`` series, one for each
    stored posting of the query's terms; the batched program's series stays."""
    csr, query, mask, l_max, n_pad, top_k = _staged_case(rng, case)
    want = ref.score_postings_topk_pre(
        *map(jnp.asarray, csr), jnp.asarray(query), None if mask is None else jnp.asarray(mask),
        l_max=l_max, n_pad=n_pad, top_k=top_k)
    offsets, lengths, docs, weights = map(_t, csr)
    state = SimpleNamespace(lex_offsets=offsets, lex_lengths=lengths, lex_pd=docs,
                            lex_pt=weights, lex_l_max=l_max, n_pad=n_pad)
    entries = rag_metrics.counter("bm25_tiered_entries_total")
    before = (entries.value(), entries.value({"path": "staged"}))
    got = lexical_search_sorted(state, _t(query), top_k, None if mask is None else _t(mask))
    _bit_equal(want, got)
    assert got[0].shape == (top_k,) and got[0].dtype == torch.int64
    stored = sum(int(csr[1][t]) for t in query if t >= 0)
    assert entries.value({"path": "staged"}) - before[1] == stored
    assert entries.value() == before[0]
    if case in ("oov_only", "few_matches"):
        assert int((got[0] >= 0).sum()) == stored


def test_sparse_windows_max_combine(rng):
    b, q, w, n_pad = 3, 5, 6, 40
    docs = rng.integers(0, n_pad + 1, size=(b, q, w)).astype(np.int32)
    slots = np.broadcast_to(np.arange(q, dtype=np.int32)[None, :, None], (b, q, w))
    contribs = np.round(rng.random((b, q, w)), 2).astype(np.float32)
    for combine, bound in (("max", None), ("max", 3), ("sum", None)):
        want = jax.vmap(
            lambda d, s, c: ref._sparse_topk_from_windows(
                d, s, c, q, n_pad, 10, combine=combine, run_bound=bound)
        )(jnp.asarray(docs), jnp.asarray(slots), jnp.asarray(contribs))
        got = port.sparse_topk_from_windows(
            _t(docs).reshape(b, -1), _t(np.ascontiguousarray(slots)).reshape(b, -1),
            _t(contribs).reshape(b, -1), q, n_pad, 10, combine=combine, run_bound=bound,
        )
        _bit_equal(want, got)


def test_idf_and_denominator():
    df = np.array([1, 5, 100, 0], np.float32)
    np.testing.assert_array_equal(
        np.asarray(ref.bm25_idf(1000, jnp.asarray(df))), port.bm25_idf(1000, _t(df)).numpy()
    )
    dl = np.array([3.0, 10.0, 0.0], np.float32)
    np.testing.assert_allclose(
        np.asarray(ref.bm25_denom_k1(jnp.asarray(dl), jnp.float32(7.5), 1.5, 0.75)),
        port.bm25_denom_k1(_t(dl), torch.tensor(7.5), 1.5, 0.75).numpy(),
        rtol=1e-7,
    )
