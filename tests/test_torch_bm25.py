"""The port's sorted-postings BM25 top-k against the JAX ops on a random CSR:
ids and scores bit-equal (the doubling reduction keeps the reference's order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from triple_hybrid_rag_tpu.ops import bm25 as ref
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


@pytest.mark.parametrize("scoped", [False, True])
def test_tiered_bit_equal(rng, scoped):
    n_pad, l_max, l_small, top_k, b = 320, 40, 8, 200, 4
    csr = _csr(rng)
    lengths = csr[1]
    qs = np.full((b, 8), -1, np.int32)
    ss = np.zeros((b, 8), np.int32)
    ql = np.full((b, 3), -1, np.int32)
    sl = np.zeros((b, 3), np.int32)
    for i, row in enumerate(_queries(rng, b, 8, 60)):
        small = [(t, s) for s, t in enumerate(row) if t >= 0 and lengths[t] <= l_small]
        large = [(t, s) for s, t in enumerate(row) if t >= 0 and lengths[t] > l_small][:3]
        for j, (t, s) in enumerate(small):
            qs[i, j], ss[i, j] = t, s
        for j, (t, s) in enumerate(large):
            ql[i, j], sl[i, j] = t, s
    masks = rng.random((b, n_pad)) > 0.4 if scoped else None
    want = jax.vmap(
        lambda a, c, d, e, m: ref.score_postings_topk_tiered(
            *map(jnp.asarray, csr), a, c, d, e, m,
            l_small=l_small, l_max=l_max, n_pad=n_pad, top_k=top_k),
        in_axes=(0, 0, 0, 0, 0 if scoped else None),
    )(*map(jnp.asarray, (qs, ss, ql, sl)), jnp.asarray(masks) if scoped else None)
    got = port.score_postings_topk_tiered(
        *map(_t, csr), *map(_t, (qs, ss, ql, sl)), _t(masks) if scoped else None,
        l_small=l_small, l_max=l_max, n_pad=n_pad, top_k=top_k,
    )
    _bit_equal(want, got)


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
