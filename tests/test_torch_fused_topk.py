"""The port's fused dense top-k (plain path of ``csrc/fused_topk.cu``) against the
JAX Pallas kernel in interpret mode, for f32 and bf16 rows (int8 and packed-int4
rows: ``tests/test_torch_quantized.py``).

ids must be equal; scores agree within 1e-5 (f32 sums of the same exact products
in another order). The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from triple_hybrid_rag_tpu.ops.pallas.fused_topk import (
    bucket_maxima_pallas,
    fused_dense_topk as ref_fused,
)
from triple_hybrid_rag_tpu_torch.ops import fused_topk as port

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _unit_rows(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _check(ref_out, got, atol=1e-5):
    r_ids, r_vals = (np.asarray(x) for x in ref_out)
    np.testing.assert_array_equal(r_ids, got[0].numpy())
    np.testing.assert_array_equal(np.isfinite(r_vals), torch.isfinite(got[1]).numpy())
    fin = np.isfinite(r_vals)
    np.testing.assert_allclose(got[1].numpy()[fin], r_vals[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_float_paths_match(rng, jdt, tdt):
    n, d, b, k = 3000, 64, 4, 24  # n not a multiple of the block
    mat = _unit_rows(rng, n, d)
    valid = np.ones(n, bool)
    valid[:100] = False
    q = _unit_rows(rng, b, d)
    want = ref_fused(jnp.asarray(mat, dtype=jdt), jnp.asarray(valid), jnp.asarray(q), k,
                     block=512, interpret=True)
    got = port.fused_dense_topk(torch.from_numpy(mat).to(tdt), torch.from_numpy(valid),
                                torch.from_numpy(q), k)
    _check(want, got)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_bucket_maxima_match(rng, jdt, tdt):
    n, d, b = 2048, 64, 3
    mat = _unit_rows(rng, n, d)
    valid = rng.random(n) > 0.1
    coll = rng.integers(0, 3, n).astype(np.int32)
    cid = np.array([-1, 1, -2], np.int32)
    q = _unit_rows(rng, b, d)
    addmask = np.where(valid, 0.0, -np.inf).astype(np.float32)[None, :]
    emb = jnp.asarray(mat, dtype=jdt)
    want = bucket_maxima_pallas(
        emb, jnp.asarray(q), jnp.asarray(addmask),
        collection_of=jnp.asarray(coll)[None, :], coll_cid=jnp.asarray(cid)[None, :],
        block=512, bucket=16, interpret=True,
    )
    got = port.bucket_maxima(torch.from_numpy(mat).to(tdt), torch.from_numpy(q),
                             torch.from_numpy(valid), torch.from_numpy(coll), torch.from_numpy(cid))
    w = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(w), torch.isinf(got).numpy())
    np.testing.assert_allclose(got.numpy()[np.isfinite(w)], w[np.isfinite(w)], atol=1e-5, rtol=0)
    assert np.all(np.isinf(w[2]))  # cid -2 matches nothing


def test_scoped_collections(rng):
    n, d, b, k = 2048, 64, 6, 16
    mat = _unit_rows(rng, n, d)
    valid = np.ones(n, bool)
    coll = rng.integers(0, 3, n).astype(np.int32)
    cid = np.array([-1, 0, 1, 2, -2, 1], np.int32)
    q = _unit_rows(rng, b, d)
    want = ref_fused(jnp.asarray(mat), jnp.asarray(valid), jnp.asarray(q), k,
                     collection_of=jnp.asarray(coll), coll_cid=jnp.asarray(cid),
                     block=512, interpret=True)
    got = port.fused_dense_topk(torch.from_numpy(mat), torch.from_numpy(valid),
                                torch.from_numpy(q), k, torch.from_numpy(coll),
                                torch.from_numpy(cid))
    _check(want, got)
    assert bool((got[0][4] == -1).all())


def test_ties_within_one_bucket(rng):
    n, d, b, k = 512, 64, 2, 8
    mat = _unit_rows(rng, n, d)
    mat[128:144] = mat[128]  # a full bucket of identical rows
    q = np.repeat(mat[128:129], b, axis=0)
    valid = np.ones(n, bool)
    want = ref_fused(jnp.asarray(mat), jnp.asarray(valid), jnp.asarray(q), k,
                     block=256, interpret=True)
    got = port.fused_dense_topk(torch.from_numpy(mat), torch.from_numpy(valid),
                                torch.from_numpy(q), k)
    _check(want, got)
    assert set(range(128, 136)) == set(got[0][0].tolist())


def test_k_exceeds_buckets_and_all_invalid(rng):
    n, d, b, k = 40, 32, 2, 64
    mat = _unit_rows(rng, n, d)
    q = _unit_rows(rng, b, d)
    for valid in (np.arange(n) < 10, np.zeros(n, bool)):
        want = ref_fused(jnp.asarray(mat), jnp.asarray(valid), jnp.asarray(q), k,
                         block=256, interpret=True)
        got = port.fused_dense_topk(torch.from_numpy(mat), torch.from_numpy(valid),
                                    torch.from_numpy(q), k)
        _check(want, got)
        assert got[0].shape == (b, k)


def test_int_rows_are_not_ported():
    """Keeps its name from before quantized rows were ported: int8 rows now run
    (``tests/test_torch_quantized.py`` holds them to the reference), and what still
    raises is a call that leaves out their scales."""
    rows = torch.zeros((16, 8), dtype=torch.int8)
    valid = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError):
        port.fused_dense_topk(rows, valid, torch.zeros((1, 8)), 4)
    ids, vals = port.fused_dense_topk(rows, valid, torch.ones((1, 8)), 4, scales=torch.ones(16))
    assert ids.tolist() == [[0, 1, 2, 3]] and not vals.any()
    with pytest.raises(TypeError):
        port.fused_dense_topk(rows.to(torch.int16), valid, torch.zeros((1, 8)), 4)
    q_i8, q_scale = port.quantize_queries_int8(torch.tensor([[0.5, -1.0, 0.25]]))
    assert q_i8.tolist() == [[64, -127, 32]] and q_scale.shape == (1, 1)
