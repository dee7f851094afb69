"""The port's blocked-IVF dense backend (``index/ivf.py``) against the JAX reference.

Inputs are clustered unit rows made from a numpy seed, with an invalid tail, in f32,
bf16, int8 (row scales) and packed int4. Tolerances:

* ``kmeans_assign`` and the layout of ``ivf_build_local`` (perm, rows, scales) must
  be equal; the block centroids agree within 1e-6 (f32 sums of a block's rows in
  another order).
* ``ivf_topk_local`` on the reference's own layout: ids equal, scores within 1e-6
  (f32 dot products summed in another order).
* With every block probed the port's IVF returns the port's exact f32 scan: ids
  equal, and the scores are bit-equal, because both sides compute each row's score
  with the same batched matvec (``torch.bmm`` of the row against the query).
* ``Engine`` against ``ShardedEngine``, both with ``semantic_backend="ivf"``: final
  ids and refusals equal, scores within 1e-5 (the near-tie rule of
  ``tests/test_torch_engine.py`` for CombSUM's min-max normalisation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.index import dense_index as ref_dense
from triple_hybrid_rag_tpu.index import ivf as ref_ivf
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh

from test_torch_engine import QUERIES, _compare, _retriever
from torch_port_helpers import state_from_retriever
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.index import ivf
from triple_hybrid_rag_tpu_torch.index.state import _to_tensor
from triple_hybrid_rag_tpu_torch.ops.topk import sort_topk_desc

DTYPES = ["float32", "bfloat16", "int8", "int4"]
N, D, W = 256, 32, 16  # rows, width, block rows
N_VALID = 232


def _clustered(seed, n=N, d=D, groups=6, spread=0.12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((groups, d)).astype(np.float32)
    r = centers[rng.integers(0, groups, size=n)] + spread * rng.standard_normal((n, d)).astype(
        np.float32
    )
    return (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(np.float32)


def _rows(dtype, seed=0):
    """(reference rows, reference scales | None, port rows, port scales | None)."""
    mat = _clustered(seed)
    if dtype in ("int8", "int4"):
        quant = ref_dense.quantize_rows_int8 if dtype == "int8" else ref_dense.quantize_rows_int4
        vals, scales = quant(mat)
        return jnp.asarray(vals), jnp.asarray(scales), torch.from_numpy(vals), torch.from_numpy(scales)
    ref = jnp.asarray(mat, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return ref, None, _to_tensor(np.asarray(ref), "cpu"), None


def _bits(t):
    """A tensor as comparable numpy: bf16 by its bit patterns."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _valid(n=N):
    return np.arange(n) < N_VALID


@pytest.mark.parametrize("dtype", DTYPES)
def test_kmeans_assign_matches_reference(dtype):
    ref_rows, ref_scales, rows, scales = _rows(dtype)
    valid = _valid()
    for clusters, iters in ((6, 8), (16, 3)):
        want = np.asarray(ref_ivf.kmeans_assign(
            ref_rows, ref_scales, jnp.asarray(valid), n_clusters=clusters, iters=iters, block=64
        ))
        got = ivf.kmeans_assign(rows, scales, torch.from_numpy(valid), n_clusters=clusters,
                                iters=iters, block=64).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[N_VALID:] == clusters).all() and (got[:N_VALID] < clusters).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_build_local_matches_reference(dtype):
    ref_rows, ref_scales, rows, scales = _rows(dtype, seed=1)
    valid = _valid()
    r_rows, r_scales, r_perm, r_cent = ref_ivf.ivf_build_local(
        ref_rows, ref_scales, jnp.asarray(valid), block_rows=W, iters=4
    )
    rows_r, scales_r, perm, cent = ivf.ivf_build_local(
        rows, scales, torch.from_numpy(valid), block_rows=W, iters=4
    )
    np.testing.assert_array_equal(perm.numpy(), np.asarray(r_perm))
    np.testing.assert_array_equal(_bits(rows_r), _bits(_to_tensor(np.asarray(r_rows), "cpu")))
    if scales is None:
        assert scales_r is None and r_scales is None
    else:
        np.testing.assert_array_equal(scales_r.numpy(), np.asarray(r_scales))
    assert cent.shape == (N // W, D)
    np.testing.assert_allclose(cent.numpy(), np.asarray(r_cent), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_ivf_topk_local_on_the_reference_layout(dtype, masked):
    ref_rows, ref_scales, _, _ = _rows(dtype, seed=2)
    valid = _valid()
    layout = ref_ivf.ivf_build_local(ref_rows, ref_scales, jnp.asarray(valid), block_rows=W)
    rng = np.random.default_rng(3)
    q = _clustered(4, n=5)
    mask = rng.random((5, N)) < 0.6 if masked else None
    for probes in (3, N // W):
        want_ids, want_vals = ref_ivf.ivf_topk_local(
            *layout, jnp.asarray(q), probes=probes, top_k=10,
            row_mask=None if mask is None else jnp.asarray(mask),
        )
        t_layout = [None if x is None else _to_tensor(np.asarray(x), "cpu") for x in layout]
        ids, vals = ivf.ivf_topk_local(
            *t_layout, torch.from_numpy(q), probes=probes, top_k=10,
            row_mask=None if mask is None else torch.from_numpy(mask),
        )
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_probes_give_the_exact_scan(dtype):
    """Every block probed: the port's IVF returns the port's exact f32 scan of the
    dequantized rows, ties included (duplicate rows force them), bit for bit."""
    _, _, rows, scales = _rows(dtype, seed=5)
    rows[10], rows[11] = rows[50], rows[50]
    if scales is not None:
        scales[10], scales[11] = scales[50], scales[50]
    valid = torch.from_numpy(_valid())
    layout = ivf.ivf_build_local(rows, scales, valid, block_rows=W)
    q = torch.from_numpy(_clustered(6, n=4))
    ids, vals = ivf.ivf_topk_local(*layout, q, probes=N // W, top_k=12)
    # the exact scan with the same matvec: each row against each query, then the scale
    deq = ivf.dequant_f32(rows, None)
    exact = torch.bmm(deq.expand(q.shape[0], -1, -1), q[:, :, None])[..., 0]
    if scales is not None:
        exact = exact * scales
    exact = exact.masked_fill(~valid, float("-inf"))
    want_ids, want_vals = sort_topk_desc(exact, torch.arange(N).expand(q.shape[0], -1), 12)
    np.testing.assert_array_equal(ids.numpy(), want_ids.numpy())
    np.testing.assert_array_equal(vals.numpy(), want_vals.numpy())


@pytest.fixture
def cfg(small_config):
    return small_config.replace(
        embedding_dtype="float32", safety_threshold=0.2, capacity_round=8
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("probes", [2, 64])
def test_engine_ivf_matches_sharded_engine(cfg, dtype, probes):
    c = cfg.replace(
        semantic_backend="ivf", ivf_block_rows=8, ivf_probes=probes, embedding_dtype=dtype,
        graph_enabled=False,
    )
    ret = _retriever(c, False)
    ref_eng = ShardedEngine(ret, single_device_mesh())
    st = state_from_retriever(ret)
    assert ref_eng.ivf_mode and st.ivf_mode and st.n_pad == ref_eng.n_pad
    np.testing.assert_array_equal(st.ivf_perm.numpy(), np.asarray(ref_eng.ivf_perm))
    np.testing.assert_allclose(
        st.ivf_centroids.numpy(), np.asarray(ref_eng.ivf_centroids), atol=1e-6, rtol=0
    )
    assert st.nbytes()["ivf"] > 0
    eng = Engine(st, device="cpu")
    _compare(ref_eng.retrieve_batch(QUERIES), eng.retrieve_batch(QUERIES))
    colls = ["a", "b", None, "nope", "a", "b"]
    _compare(
        ref_eng.retrieve_batch(QUERIES, collections=colls),
        eng.retrieve_batch(QUERIES, collections=colls),
    )
    for q in QUERIES[:3]:
        _compare(ref_eng.retrieve_batch([q]), eng.retrieve_batch([q]))
        _compare(ref_eng.retrieve_batch([q], collection="b"), eng.retrieve_batch([q], collection="b"))
    # a refreshed state keeps the IVF layout; the exact backend does not refresh into it
    assert eng.refresh(state_from_retriever(ret))
    exact = state_from_retriever(_retriever(c.replace(semantic_backend="exact"), False))
    assert not exact.ivf_mode and not eng.refresh(exact)
