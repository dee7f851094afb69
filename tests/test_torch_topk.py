"""The port's top-k ops against the JAX reference ops: exact equality of ids and
scores, including ties, +0.0 / -0.0, all-invalid rows and k beyond the width."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from triple_hybrid_rag_tpu.ops import topk as ref
from triple_hybrid_rag_tpu_torch.ops import topk as port


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(ref_pair, got_pair):
    np.testing.assert_array_equal(np.asarray(ref_pair[0]), got_pair[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref_pair[1]), got_pair[1].numpy())


def test_lax_top_k_signed_zero_and_ties():
    x = np.array([0.0, -0.0, 1.0, -0.0, 0.0], np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(x), 3)
    pv, pi = port.lax_top_k(_t(x), 3)
    np.testing.assert_array_equal(np.asarray(idx), pi.numpy())  # [2, 0, 4]: +0 above -0
    np.testing.assert_array_equal(np.signbit(np.asarray(vals)), np.signbit(pv.numpy()))


@pytest.mark.parametrize("k", [-1, 9, 12])
def test_lax_top_k_past_the_width_raises_as_jax_does(k):
    """k past the last axis, or below 0: ValueError with ``jax.lax.top_k``'s message."""
    x = np.arange(16, dtype=np.float32).reshape(2, 8)
    with pytest.raises(ValueError) as want:
        jax.lax.top_k(jnp.asarray(x), k)
    with pytest.raises(ValueError) as got:
        port.lax_top_k(_t(x), k)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [3, 8, 12])
def test_sort_topk_desc(rng, k):
    scores = np.array(
        [[0.5, -0.0, 0.0, 0.5, -np.inf, 2.0, 0.0, 0.5], [-np.inf] * 8], np.float32
    )
    ids = np.array([[7, 3, 1, 2, 9, 4, 0, 5], [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    _eq(ref.sort_topk_desc(jnp.asarray(scores), jnp.asarray(ids), k),
        port.sort_topk_desc(_t(scores), _t(ids), k))


@pytest.mark.parametrize("k", [4, 16, 40])
def test_masked_top_k(rng, k):
    s = np.round(rng.standard_normal(32), 1).astype(np.float32)  # many exact ties
    s[[3, 9]] = [0.0, -0.0]
    valid = rng.random(32) > 0.3
    for floor in (0.0, -2.0):
        _eq(ref.masked_top_k(jnp.asarray(s), k, jnp.asarray(valid), floor),
            port.masked_top_k(_t(s), k, _t(valid), floor))
    _eq(ref.masked_top_k(jnp.asarray(s), k, jnp.asarray(np.zeros(32, bool))),
        port.masked_top_k(_t(s), k, _t(np.zeros(32, bool))))


def test_merge_topk(rng):
    ids = rng.integers(0, 20, size=(3, 6)).astype(np.int32)
    ids[1, 2:] = -1
    scores = np.round(rng.random((3, 6)), 1).astype(np.float32)
    for k in (4, 18, 25):
        got = port.merge_topk(_t(ids)[None], _t(scores)[None], k)  # one batch row
        _eq(ref.merge_topk(jnp.asarray(ids), jnp.asarray(scores), k), (got[0][0], got[1][0]))


@pytest.mark.parametrize("n,bucket", [(5000, 16), (4097, 8), (300, 16), (7, 16)])
def test_bucketed_topk_parity(rng, n, bucket):
    B, K = 6, 24
    scores = rng.standard_normal((B, n)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, max(1, n // 50))] = False
    _eq(ref.bucketed_masked_top_k_batch(jnp.asarray(scores), K, valid=jnp.asarray(valid),
                                        invalid_score_floor=-2.0, bucket=bucket),
        port.bucketed_masked_top_k_batch(_t(scores), K, valid=_t(valid),
                                         invalid_score_floor=-2.0, bucket=bucket))


def test_bucketed_topk_ties_floor_and_per_query_valid(rng):
    scores = np.zeros((3, 8192), np.float32)
    scores[:, 100:140] = 1.0  # 40 exactly tied hits spanning buckets
    scores[:, 7000] = 2.0
    scores[1, 200] = -0.0
    _eq(ref.bucketed_masked_top_k_batch(jnp.asarray(scores), 16),
        port.bucketed_masked_top_k_batch(_t(scores), 16))
    s2 = rng.random((4, 6000), dtype=np.float32)
    valid = rng.random((4, 6000)) > 0.3
    _eq(ref.bucketed_masked_top_k_batch(jnp.asarray(s2), 12, valid=jnp.asarray(valid)),
        port.bucketed_masked_top_k_batch(_t(s2), 12, valid=_t(valid)))
    none = np.zeros((2, 6000), bool)
    _eq(ref.bucketed_masked_top_k_batch(jnp.asarray(s2[:2]), 12, valid=jnp.asarray(none)),
        port.bucketed_masked_top_k_batch(_t(s2[:2]), 12, valid=_t(none)))
