"""The port's graph channel and fusion tail against the JAX ops: ids exact, scores
within 1e-6 (the BM25-style segmented max and the rank arithmetic are exact)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from triple_hybrid_rag_tpu.ops import fusion as ref_fusion
from triple_hybrid_rag_tpu.ops import graph as ref_graph
from triple_hybrid_rag_tpu.parallel.engine import _shard_mentions
from triple_hybrid_rag_tpu_torch.index.state import mention_csr
from triple_hybrid_rag_tpu_torch.ops import fusion as port_fusion
from triple_hybrid_rag_tpu_torch.ops import graph as port_graph


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX hands out read-only views)


def _graph(rng, e=40, deg=4, n=600, m=4):
    nbr = rng.integers(0, e, size=(e, deg)).astype(np.int32)
    nbr[rng.random((e, deg)) < 0.4] = -1
    ce = rng.integers(0, e, size=(n, m)).astype(np.int32)
    ce[rng.random((n, m)) < 0.5] = -1
    seeds = np.full((3, 4), -1, np.int32)
    seeds[0, :2] = [3, 7]
    seeds[1, :1] = [0]
    return nbr, ce, seeds


def _ent_scores(nbr, seeds, hops=2):
    e = nbr.shape[0]
    svec = np.zeros((seeds.shape[0], e), bool)
    for i, row in enumerate(seeds):
        svec[i, row[row >= 0]] = True
    dist = np.stack([np.asarray(ref_graph.khop_distances(jnp.asarray(nbr), jnp.asarray(s), hops=hops))
                     for s in svec])
    reach = dist <= hops
    return svec, dist, np.where(reach, 1.0 / (1.0 + dist), 0.0).astype(np.float32)


def test_khop_distances(rng):
    nbr, _, seeds = _graph(rng)
    svec, dist, _ = _ent_scores(nbr, seeds)
    got = port_graph.khop_distances(_t(nbr), port_graph.seed_vectors(_t(seeds), nbr.shape[0]), hops=2)
    np.testing.assert_array_equal(got.numpy(), dist)


@pytest.mark.parametrize("masked", [False, True])
def test_graph_topk_batch(rng, masked):
    nbr, ce, seeds = _graph(rng)
    _, dist, ent = _ent_scores(nbr, seeds)
    on = np.array([True, True, False])
    ranks = np.where((dist <= 2) & on[:, None], 3.0 - dist, 0).astype(np.uint8)
    valid = rng.random((3, ce.shape[0])) > 0.3 if masked else None
    kw = dict(valid=None if valid is None else jnp.asarray(valid), query_on=jnp.asarray(on),
              bucket=16, block=256)
    for r in (None, ranks):
        want = ref_graph.graph_topk_batch(jnp.asarray(ce), jnp.asarray(ent), 20,
                                          entity_ranks=None if r is None else jnp.asarray(r), **kw)
        got = port_graph.graph_topk_batch(
            _t(ce), _t(ent), 20, valid=None if valid is None else _t(valid), query_on=_t(on),
            bucket=16, block=256, entity_ranks=None if r is None else _t(r),
        )
        np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)


def test_graph_sparse_topk_and_mention_csr(rng):
    nbr, ce, seeds = _graph(rng)
    _, _, ent = _ent_scores(nbr, seeds)
    e_pad, n = nbr.shape[0], ce.shape[0]
    off, ln, docs, l_max, trunc = mention_csr(ce, e_pad, cap=30)
    r_off, r_ln, r_docs, r_l, r_trunc = _shard_mentions(ce, n, 1, e_pad, 30)
    np.testing.assert_array_equal(off, np.asarray(r_off)[0])
    np.testing.assert_array_equal(ln, np.asarray(r_ln)[0])
    np.testing.assert_array_equal(docs, np.asarray(r_docs)[0])
    assert (l_max, trunc) == (r_l, r_trunc)
    act_s, act_e = jax.lax.top_k(jnp.asarray(ent), 16)
    act_e = jnp.where(act_s > 0, act_e, -1)
    mask = rng.random((3, n)) > 0.2
    want = jax.vmap(lambda a, s, m: ref_graph.graph_sparse_topk(
        jnp.asarray(off), jnp.asarray(ln), jnp.asarray(docs), a, s, m,
        l_max_g=l_max, n_pad=n, top_k=20, run_bound=ce.shape[1]))(act_e, act_s, jnp.asarray(mask))
    got = port_graph.graph_sparse_topk(
        _t(off), _t(ln), _t(docs), _t(act_e), _t(act_s), _t(mask),
        l_max_g=l_max, n_pad=n, top_k=20, run_bound=ce.shape[1],
    )
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())


def _channels(rng, b=4, k=10, pool=30):
    out = []
    for _ in range(3):
        ids = np.stack([rng.choice(pool, size=k, replace=False) for _ in range(b)]).astype(np.int32)
        scores = -np.sort(-rng.random((b, k)).astype(np.float32), axis=1)
        ids[:, k - 3:] = -1
        scores[:, k - 3:] = -np.inf
        out += [ids, scores]
    out[0][2] = -1  # an empty lexical list
    out[1][2] = -np.inf
    return out


@pytest.mark.parametrize("blend,gate", [(0.0, 0.0), (1.0, 12.0), (0.4, 3.0)])
def test_fuse_rrf(rng, blend, gate):
    ch = _channels(rng)
    w = rng.random((4, 3)).astype(np.float32)
    want = jax.vmap(lambda *a: ref_fusion.fuse_rrf(*a, rrf_k=60, top_k=12, score_blend=blend,
                                                   lex_conf_gate=gate))(*map(jnp.asarray, ch), jnp.asarray(w))
    got = port_fusion.fuse_rrf(*map(_t, ch), _t(w), rrf_k=60, top_k=12, score_blend=blend,
                               lex_conf_gate=gate)
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy())
    np.testing.assert_array_equal(np.asarray(want.channels), got.channels.numpy())
    for f in ("rrf", "lexical", "semantic", "graph"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-6)


def test_conformal_minmax_and_safety(rng):
    ids = rng.integers(0, 50, size=(4, 12)).astype(np.int32)
    ids[1, 2:] = -1  # fewer than 3 valid: identity
    ids[2, :] = -1
    scores = rng.random((4, 12)).astype(np.float32)
    scores[3, :] = 0.5  # all equal
    keep = jax.vmap(ref_fusion.conformal_denoise_mask, in_axes=(0, 0, None))(
        jnp.asarray(ids), jnp.asarray(scores), jnp.float32(0.6))
    np.testing.assert_array_equal(
        np.asarray(keep), port_fusion.conformal_denoise_mask(_t(ids), _t(scores), torch.tensor(0.6)).numpy())
    mm = jax.vmap(ref_fusion.minmax_normalize)(jnp.asarray(ids), jnp.asarray(scores))
    np.testing.assert_allclose(port_fusion.minmax_normalize(_t(ids), _t(scores)).numpy(), np.asarray(mm),
                               atol=1e-6)
    gate_scores = rng.random((4, 12)).astype(np.float32)
    for thr, alpha in ((0.0, 0.6), (0.7, 0.6), (0.3, 0.0)):
        want = jax.vmap(lambda i, s, g: ref_fusion.apply_safety_denoise(
            i, s, jnp.float32(thr), jnp.float32(alpha), top_k=5, gate_scores=g))(
            jnp.asarray(ids), jnp.asarray(scores), jnp.asarray(gate_scores))
        got = port_fusion.apply_safety_denoise(
            _t(ids), _t(scores), torch.tensor(thr), torch.tensor(alpha), top_k=5,
            gate_scores=_t(gate_scores))
        np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy())
        np.testing.assert_array_equal(np.asarray(want.refused), got.refused.numpy())
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
        np.testing.assert_allclose(got.max_score.numpy(), np.asarray(want.max_score), atol=1e-6)
