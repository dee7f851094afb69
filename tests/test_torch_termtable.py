"""The port's term-table BM25 scoring (plain path of ``csrc/termtable.cu``) against
the JAX reference: ``ops/bm25.score_termtable`` / ``score_termtable_batch`` and the
Pallas kernel ``score_termtable_pallas`` in interpret mode.

Scores agree within 1e-5 absolute, not bit for bit: each is an f32 sum of at most Q
non-zero weights below 1, taken over the table's slots in another order than XLA's
reduce. The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` to the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.ops import bm25 as ref
from triple_hybrid_rag_tpu.ops.pallas import score_termtable_pallas
from triple_hybrid_rag_tpu_torch.ops import bm25 as port

ATOL = 1e-5


def _table(rng, n, width, vocab=500, pad_frac=0.3):
    term_ids = rng.integers(0, vocab, size=(n, width)).astype(np.int32)
    term_ids[rng.random((n, width)) < pad_frac] = ref.DOC_PAD
    weights = rng.random((n, width)).astype(np.float32)
    return term_ids, weights


def _weights(weights, dtype):
    """The same weights for both packages, in f32 or rounded to bf16."""
    if dtype == "float32":
        return jnp.asarray(weights), torch.from_numpy(weights)
    t = torch.from_numpy(weights).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16), t


def test_pads_are_the_reference_sentinels():
    assert (port.QUERY_PAD, port.DOC_PAD) == (ref.QUERY_PAD, ref.DOC_PAD) == (-1, -2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_termtable_matches_reference_and_pallas(rng, dtype):
    n, width = 1000, 16  # n not a multiple of the Pallas block
    term_ids, weights = _table(rng, n, width)
    query = np.array([3, 77, 200, 499, -1, -1, -1, -1], np.int32)
    w_j, w_t = _weights(weights, dtype)
    got = port.score_termtable(torch.from_numpy(term_ids), w_t, torch.from_numpy(query))
    assert got.shape == (n,) and got.dtype == torch.float32
    want = ref.score_termtable(jnp.asarray(term_ids), w_j, jnp.asarray(query))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    kernel = score_termtable_pallas(jnp.asarray(term_ids), w_j, jnp.asarray(query), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL, rtol=0)
    assert float(got.max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_termtable_batch_matches_reference(rng, dtype):
    n, width, b, q = 700, 24, 5, 8
    term_ids, weights = _table(rng, n, width, vocab=60)
    queries = rng.integers(0, 60, size=(b, q)).astype(np.int32)
    queries[0, 3:] = -1  # trailing pads
    queries[1, :] = -1  # an empty query scores nothing
    queries[2, 2] = -1  # a pad between live terms
    queries[3, 1] = queries[3, 0]  # a repeated term counts once
    w_j, w_t = _weights(weights, dtype)
    got = port.score_termtable_batch(torch.from_numpy(term_ids), w_t, torch.from_numpy(queries))
    want = ref.score_termtable_batch(jnp.asarray(term_ids), w_j, jnp.asarray(queries))
    assert got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not got[1].any() and float(got[0].max()) > 0
    # an independent oracle: the loop over documents
    oracle = np.zeros((b, n), np.float64)
    wf = w_t.float().numpy()
    for i in range(b):
        live = set(queries[i][queries[i] >= 0].tolist())
        for doc in range(n):
            oracle[i, doc] = sum(wf[doc, s] for s in range(width) if term_ids[doc, s] in live)
    np.testing.assert_allclose(got.numpy(), oracle, atol=ATOL, rtol=0)


def test_row_padding_of_minus_one_matches_query_pads(rng):
    """A table row padded with -1 (as the reference's engine pads rows) equals the
    query's empty slots; both packages then add that slot's weight."""
    term_ids, weights = _table(rng, 64, 8, vocab=20, pad_frac=0.0)
    term_ids[5, 2] = -1
    query = np.array([1, 2, -1, -1], np.int32)
    got = port.score_termtable(*(torch.from_numpy(x) for x in (term_ids, weights, query)))
    want = ref.score_termtable(jnp.asarray(term_ids), jnp.asarray(weights), jnp.asarray(query))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    full = np.array([1, 2, 3, 4], np.int32)  # no empty slot: the -1 id matches nothing
    got = port.score_termtable(*(torch.from_numpy(x) for x in (term_ids, weights, full)))
    want = ref.score_termtable(jnp.asarray(term_ids), jnp.asarray(weights), jnp.asarray(full))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_synthetic_term_table_agrees_with_its_postings():
    """The synthetic corpus scores alike through both lexical layouts when no
    posting is cut (bm25_df_cap = 0): same top lexical ids, scores within 1e-4 (f32
    sums of weights up to ~10 in two orders)."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.synthetic import L_DOC, build_synthetic, term_str

    n, dim, n_ent = 2048, 32, 100
    base = RAGConfig(
        capacity_round=1024, embedding_dim=dim, embedding_dim_full=dim, maxsim_doc_tokens=8,
        maxsim_dim=16, maxsim_query_tokens=8, safety_threshold=0.0,
        graph_max_entities_per_chunk=4, bm25_df_cap=0, embedder_backend="bowhash",
        lexical_backend="sorted",
    )
    syn_s = build_synthetic(base, n, dim, n_ent, seed=3, device="cpu")
    syn_t = build_synthetic(base.replace(lexical_backend="termtable"), n, dim, n_ent, seed=3,
                            device="cpu")
    st = syn_t.state
    assert st.lexical_mode == "termtable" and st.lex_offsets is None
    assert st.term_ids.shape == (2048, base.doc_term_capacity) and st.term_ids.dtype == torch.int32
    np.testing.assert_array_equal(syn_s.term_ids, syn_t.term_ids)
    # row 0: unique terms ascending, then pads; a duplicated term weighs its count
    doc = syn_t.term_ids[0]
    uniq, counts = np.unique(doc, return_counts=True)
    assert st.term_ids[0, : len(uniq)].tolist() == uniq.tolist()
    assert bool((st.term_ids[0, len(uniq):] == port.DOC_PAD).all()) and len(uniq) <= L_DOC
    unit = st.term_weights[0, : len(uniq)] / torch.from_numpy(counts).float()
    idf = torch.from_numpy(syn_s.state.idf)[torch.from_numpy(uniq).long()]
    np.testing.assert_allclose(unit.numpy(), idf.numpy(), rtol=1e-6)  # k1+1 over 1+k1 is 1

    eng_s = Engine(syn_s.state, embedder=syn_s.embedder, device="cpu")
    eng_t = Engine(st, embedder=syn_t.embedder, device="cpu")
    # queries from each row's rare terms: a frequent term has more occurrences than
    # the postings keep (one posting per occurrence, at most n per term), and the
    # term table keeps them all, so the two layouts agree only on uncut terms
    rows = np.random.default_rng(7).integers(0, n, size=24)
    uncut = syn_s.state.stored_df < 64
    texts = []
    for r in rows:
        terms = [int(t) for t in dict.fromkeys(syn_t.term_ids[r].tolist()) if uncut[t]][:8]
        assert len(terms) >= 4
        texts.append(" ".join(term_str(t) for t in terms))
    ids_s, vals_s = eng_s._lexical(eng_s.prepare_queries(texts)[1], None)
    ids_t, vals_t = eng_t._lexical(eng_t.prepare_queries(texts)[1], None)
    np.testing.assert_allclose(vals_t.numpy(), vals_s.numpy(), atol=1e-4, rtol=0)
    assert ids_t[:, 0].tolist() == ids_s[:, 0].tolist() == rows.tolist()  # own document first
    assert float((ids_t == ids_s).float().mean()) > 0.9  # the rest up to exact ties' order


# Shapes the CUDA kernel has to get right (a membership table per 128 queries, a
# warp per row over chunks of 32 slots, tiles of 32 rows): (n, table width, b, q).
EDGE_SHAPES = [
    (31, 1, 2, 2),  # one slot a row, rows short of a tile
    (100, 40, 1, 16),  # width not a multiple of 32, one query
    (333, 128, 130, 16),  # more than one block of 128 queries, n not a multiple of 32
    (70, 800, 3, 32),  # wider than 768 slots, the most query slots
    (257, 96, 128, 1),  # a single query slot
]


def _edge_case(rng, n, width, b, q):
    """A table and queries holding every special case at once: a table id of -1, a
    term repeated inside a query, one term held by every query, a query of only
    pads. The vocabulary grows with the width, so a score stays a sum of about ten
    weights and the tolerance of the file holds."""
    vocab = max(50, 4 * width)
    term_ids, weights = _table(rng, n, width, vocab=vocab, pad_frac=0.4)
    term_ids[::7, 0] = -1
    queries = rng.integers(0, vocab, size=(b, q)).astype(np.int32)
    queries[:, q // 2 + 1:] = -1
    queries[:, 0] = 7
    if q > 1:
        queries[0, 1] = queries[0, 0]
    if b > 1:
        queries[1, :] = -1
    return term_ids, weights, queries


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,width,b,q", EDGE_SHAPES)
def test_score_termtable_batch_edge_shapes(rng, n, width, b, q, dtype):
    term_ids, weights, queries = _edge_case(rng, n, width, b, q)
    w_j, w_t = _weights(weights, dtype)
    got = port.score_termtable_batch(torch.from_numpy(term_ids), w_t, torch.from_numpy(queries))
    assert got.shape == (b, n) and got.dtype == torch.float32
    want = ref.score_termtable_batch(jnp.asarray(term_ids), w_j, jnp.asarray(queries))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert float(got.max()) > 0
    if b > 1:
        # only pads: exactly the weights of the rows' -1 slots
        pad_rows = np.zeros(n, np.float32)
        pad_rows[::7] = w_t.float().numpy()[::7, 0]
        np.testing.assert_array_equal(got[1].numpy(), pad_rows)
    if (queries[0] == -1).any():
        # the repeated term counts once: a pad in its place (the query holds pads
        # already) leaves every score as it was
        once = queries[:1].copy()
        once[0, 1] = -1
        again = port.score_termtable_batch(torch.from_numpy(term_ids), w_t, torch.from_numpy(once))
        np.testing.assert_array_equal(again[0].numpy(), got[0].numpy())
    # the Pallas kernel scores one query per call: the first and the last of the batch
    for i in sorted({0, b - 1}):
        kernel = score_termtable_pallas(jnp.asarray(term_ids), w_j, jnp.asarray(queries[i]),
                                        interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(kernel), atol=ATOL, rtol=0)


def test_a_term_held_by_every_query_scores_alike(rng):
    """128 queries of the same single term give 128 equal score rows."""
    term_ids, weights = _table(rng, 200, 24, vocab=30)
    queries = np.full((128, 4), -1, np.int32)
    queries[:, 2] = 11
    got = port.score_termtable_batch(*(torch.from_numpy(x) for x in (term_ids, weights, queries)))
    want = ref.score_termtable(jnp.asarray(term_ids), jnp.asarray(weights), jnp.asarray(queries[0]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert bool((got == got[0]).all()) and float(got.max()) > 0
