"""The port's quantized dense path (int8 and packed-int4 rows) against the JAX
reference: the row quantizers, the unpack, the batched score functions, the blocked
int4 top-k and the fused top-k (plain path of ``csrc/fused_topk.cu``) against the
Pallas kernel in interpret mode.

Everything here is exact: int32 sums, then ``(acc * row_scale) * q_scale`` in that
order in both packages, so codes, scales, ids and scores must be equal bit for bit.
One exception, which the reference's own tests state (``tests/test_fused_topk.py``):
inside the reference's jitted fused program XLA is free to reassociate the two
dequantization multiplies of the rescore, so that program's scores are held to 4 ulp
(ids still equal), while the port's fused scores are bit-equal to the reference's
unfused path (``dense_scores_int*_batch`` + ``masked_top_k``).
The CUDA kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` (max error 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.index import dense_index as ref
from triple_hybrid_rag_tpu.ops.pallas.fused_topk import (
    bucket_maxima_pallas,
    fused_dense_topk as ref_fused,
    quantize_queries_int8 as ref_quantize_queries,
)
from triple_hybrid_rag_tpu.ops.topk import masked_top_k as ref_masked_top_k
from triple_hybrid_rag_tpu_torch.index import dense_index as port
from triple_hybrid_rag_tpu_torch.ops import fused_topk as port_fused

KINDS = ["int8", "int4"]
REF_QUANTIZE = {"int8": ref.quantize_rows_int8, "int4": ref.quantize_rows_int4}
PORT_QUANTIZE = {"int8": port.quantize_rows_int8, "int4": port.quantize_rows_int4}
REF_SCORES = {"int8": ref.dense_scores_int8_batch, "int4": ref.dense_scores_int4_batch}
PORT_SCORES = {"int8": port.dense_scores_int8_batch, "int4": port.dense_scores_int4_batch}


def _unit_rows(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_same(ref_out, got):
    """(ids, scores) of the reference and the port: equal ids, equal score bits."""
    r_ids, r_vals = (np.asarray(x) for x in ref_out)
    np.testing.assert_array_equal(got[0].numpy(), r_ids)
    np.testing.assert_array_equal(got[1].numpy(), r_vals)


def _assert_same_ids_scores_ulp(ref_out, got, max_ulp=4):
    r_ids, r_vals = (np.asarray(x) for x in ref_out)
    g_vals = got[1].numpy()
    np.testing.assert_array_equal(got[0].numpy(), r_ids)
    fin = np.isfinite(r_vals)
    np.testing.assert_array_equal(fin, np.isfinite(g_vals))
    ulp = np.abs(r_vals.view(np.int32).astype(np.int64) - g_vals.view(np.int32))[fin]
    assert ulp.size == 0 or ulp.max() <= max_ulp, ulp.max()


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_rows_match(rng, kind):
    mat = _unit_rows(rng, 300, 64)
    mat[7] = 0.0  # an all-zero row: scale 1, codes 0
    mat[8] *= 1e-3
    want_rows, want_scale = REF_QUANTIZE[kind](mat)
    got_rows, got_scale = PORT_QUANTIZE[kind](torch.from_numpy(mat))
    assert got_rows.dtype == (torch.int8 if kind == "int8" else torch.uint8)
    assert got_rows.shape == want_rows.shape and got_scale.dtype == torch.float32
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    np.testing.assert_array_equal(got_scale.numpy(), want_scale)
    assert got_scale[7] == 1.0 and not got_rows[7].any()
    # bf16 rows (as the synthetic corpus quantizes them on the card) widen exactly
    bf = torch.from_numpy(mat).to(torch.bfloat16)
    b_rows, b_scale = PORT_QUANTIZE[kind](bf)
    w_rows, w_scale = REF_QUANTIZE[kind](bf.float().numpy())
    np.testing.assert_array_equal(b_rows.numpy(), w_rows)
    np.testing.assert_array_equal(b_scale.numpy(), w_scale)


def test_int4_pack_layout_and_unpack(rng):
    mat = _unit_rows(rng, 64, 32)
    packed, scale = port.quantize_rows_int4(torch.from_numpy(mat))
    assert packed.shape == (64, 16)
    low, high = port.unpack_int4(packed)
    r_low, r_high = ref.unpack_int4(jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(low.numpy(), np.asarray(r_low))
    np.testing.assert_array_equal(high.numpy(), np.asarray(r_high))
    codes = torch.cat([low, high], 1)
    assert codes.dtype == torch.int8 and int(codes.min()) >= -7 and int(codes.max()) <= 7
    recon = codes.float() * scale[:, None]
    err = (recon - torch.from_numpy(mat)).abs().amax(1) / torch.from_numpy(mat).abs().amax(1)
    assert float(err.max()) <= 0.5 / 7.0 + 1e-6
    with pytest.raises(ValueError):
        port.quantize_rows_int4(torch.zeros((1, 7)))


def test_quantize_queries_match(rng):
    q = np.concatenate([_unit_rows(rng, 5, 48), np.zeros((1, 48), np.float32)])
    want_q, want_s = ref_quantize_queries(jnp.asarray(q))
    got_q, got_s = port.quantize_queries_int8(torch.from_numpy(q))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[5].any()  # the zero vector of a failed embed: zero codes, no NaN


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b", [1, 8])
def test_dense_scores_bit_equal(rng, kind, b):
    n, d = 2000, 128
    rows, scales = REF_QUANTIZE[kind](_unit_rows(rng, n, d))
    q = _unit_rows(rng, b, d)
    want = REF_SCORES[kind](jnp.asarray(rows), jnp.asarray(scales), jnp.asarray(q))
    got = PORT_SCORES[kind](*_t(rows, scales, q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scoped", [True, False])
def test_int4_topk_blocked_parity(rng, scoped):
    """Equal to the reference's blocked top-k and to its full unpack + masked_top_k,
    on several row blocks and an N that is no multiple of the bucket."""
    n, d, b, k = 5003, 128, 6, 32
    mat = _unit_rows(rng, n, d)
    packed, scales = ref.quantize_rows_int4(mat)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, 100)] = False
    coll = rng.integers(0, 3, n).astype(np.int32)
    cid = np.array([-1, 0, 1, 2, -2, 1], np.int32)
    q = mat[rng.integers(0, n, b)] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    scope_j = dict(collection_of=jnp.asarray(coll), coll_cid=jnp.asarray(cid)) if scoped else {}
    scope_t = dict(zip(("collection_of", "coll_cid"), _t(coll, cid))) if scoped else {}

    got = port.int4_topk_blocked(*_t(packed, scales, valid, q), k, block=1024, **scope_t)
    want = ref.int4_topk_blocked(
        jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(valid), jnp.asarray(q), k,
        block=1024, **scope_j,
    )
    _assert_same(want, got)

    scores = ref.dense_scores_int4_batch(jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(q))

    def one(s, c):
        v = jnp.asarray(valid)
        if scoped:
            v = jnp.where(c == -1, v, v & (jnp.asarray(coll) == c))
        return ref_masked_top_k(s, k, valid=v, invalid_score_floor=-2.0)

    _assert_same(jax.vmap(one)(scores, jnp.asarray(cid)), got)
    if scoped:
        assert bool((got[0][4] == -1).all())  # cid -2 matches nothing


def _fused_case(rng, name):
    """The int cases of the reference's fused top-k tests: (mat, valid, q, k, block,
    collection_of, coll_cid)."""
    if name == "bit_parity":
        n, d, b, k = 5000, 128, 8, 32
        valid = np.ones(n, bool)
        valid[rng.integers(0, n, 50)] = False
        return _unit_rows(rng, n, d), valid, _unit_rows(rng, b, d), k, 512, None, None
    if name == "ties_break_by_id":  # every score four times, spread across buckets
        n, d, b, k = 1024, 64, 4, 16
        mat = np.repeat(_unit_rows(rng, n // 4, d), 4, axis=0)
        return mat, np.ones(n, bool), _unit_rows(rng, b, d), k, 256, None, None
    if name == "ties_within_one_bucket":  # a full bucket of identical rows
        n, d, b, k = 512, 64, 2, 8
        mat = _unit_rows(rng, n, d)
        mat[128:144] = mat[128]
        return mat, np.ones(n, bool), np.repeat(mat[128:129], b, axis=0), k, 256, None, None
    if name == "scoped":
        n, d, b, k = 2048, 64, 6, 16
        coll = rng.integers(0, 3, n).astype(np.int32)
        cid = np.array([-1, 0, 1, 2, -2, 1], np.int32)
        return _unit_rows(rng, n, d), np.ones(n, bool), _unit_rows(rng, b, d), k, 512, coll, cid
    if name == "k_exceeds_buckets":  # k > buckets and k > valid rows: padded output
        n, d, b, k = 40, 32, 2, 64
        return _unit_rows(rng, n, d), np.arange(n) < 10, _unit_rows(rng, b, d), k, 256, None, None
    if name == "all_invalid":
        n, d, b, k = 512, 32, 2, 8
        return _unit_rows(rng, n, d), np.zeros(n, bool), _unit_rows(rng, b, d), k, 256, None, None
    if name == "zero_query":  # a failed embed: every score exactly 0
        n, d, b, k = 600, 32, 2, 8
        q = _unit_rows(rng, b, d)
        q[1] = 0.0
        return _unit_rows(rng, n, d), np.ones(n, bool), q, k, 256, None, None
    raise KeyError(name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", [
    "bit_parity", "ties_break_by_id", "ties_within_one_bucket", "scoped",
    "k_exceeds_buckets", "all_invalid", "zero_query",
])
def test_fused_int_rows_match_pallas(rng, kind, case):
    mat, valid, q, k, block, coll, cid = _fused_case(rng, case)
    rows, scales = REF_QUANTIZE[kind](mat)
    scope_j = {} if coll is None else dict(collection_of=jnp.asarray(coll), coll_cid=jnp.asarray(cid))
    scope_t = {} if coll is None else dict(zip(("collection_of", "coll_cid"), _t(coll, cid)))
    want = ref_fused(
        jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(q), k, scales=jnp.asarray(scales),
        block=block, interpret=True, **scope_j,
    )
    t_rows, t_scales, t_valid, t_q = _t(rows, scales, valid, q)
    got = port_fused.fused_dense_topk(t_rows, t_valid, t_q, k, scales=t_scales, **scope_t)
    _assert_same_ids_scores_ulp(want, got)
    assert got[0].shape == (q.shape[0], k)

    # bit for bit against the reference's unfused path: full scores + masked top-k
    scores = REF_SCORES[kind](jnp.asarray(rows), jnp.asarray(scales), jnp.asarray(q))
    mask = np.broadcast_to(valid, (q.shape[0], valid.shape[0]))
    if coll is not None:
        mask = mask & ((cid[:, None] == -1) | (coll[None, :] == cid[:, None]))
    unfused = jax.vmap(
        lambda s, v: ref_masked_top_k(s, k, valid=v, invalid_score_floor=-2.0)
    )(scores, jnp.asarray(mask))
    _assert_same(unfused, got)
    if case == "ties_within_one_bucket":
        assert set(range(128, 136)) == set(got[0][0].tolist())
    if case == "scoped":
        assert bool((got[0][4] == -1).all())
    if case == "all_invalid":
        assert bool((got[0] == -1).all()) and bool(torch.isinf(got[1]).all())
    if case == "k_exceeds_buckets":
        assert all(int((row >= 0).sum()) == 10 for row in got[0])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scoped", [True, False])
def test_bucket_maxima_int_rows_match_pallas(rng, kind, scoped):
    n, d, b = 2048, 64, 3
    rows, scales = REF_QUANTIZE[kind](_unit_rows(rng, n, d))
    valid = rng.random(n) > 0.1
    coll = rng.integers(0, 3, n).astype(np.int32)
    cid = np.array([-1, 1, -2], np.int32)
    q = _unit_rows(rng, b, d)
    q_i8, q_scale = ref_quantize_queries(jnp.asarray(q))
    addmask = np.where(valid, 0.0, -np.inf).astype(np.float32)[None, :]
    scope_j = dict(collection_of=jnp.asarray(coll)[None, :], coll_cid=jnp.asarray(cid)[None, :])
    want = bucket_maxima_pallas(
        jnp.asarray(rows), q_i8, jnp.asarray(addmask), scales=jnp.asarray(scales)[None, :],
        q_scale=q_scale.T, block=512, bucket=16, interpret=True, **(scope_j if scoped else {}),
    )
    t_q, t_qs = port.quantize_queries_int8(torch.from_numpy(q))
    t_rows, t_scales, t_valid, t_coll, t_cid = _t(rows, scales, valid, coll, cid)
    got = port_fused.bucket_maxima(
        t_rows, t_q, t_valid, t_coll if scoped else None, t_cid if scoped else None,
        scales=t_scales, q_scale=t_qs,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if scoped:
        assert bool(torch.isinf(got[2]).all())  # cid -2 matches nothing
    with pytest.raises(ValueError):  # quantized rows need scales and int8 queries
        port_fused.bucket_maxima(t_rows, torch.from_numpy(q), t_valid)


# (n, d, b): one row, rows short of a bucket, a bucket plus one, short of the kernel's
# 64-row tile, a tile plus one, n no multiple of 16; one query, a few, more than one
# launch of 128 (130, 257); widths below and ragged against a 128-byte stage (int4:
# d/2 = 80), the serving width and one too wide for resident queries
RAGGED_SHAPES = [(1, 32, 1), (15, 32, 5), (17, 160, 1), (63, 160, 5), (65, 160, 130),
                 (127, 1024, 1), (129, 64, 257), (1000, 128, 3), (33, 4096, 5)]


def _ragged_inputs(rng, kind, n, d, b):
    rows, scales = REF_QUANTIZE[kind](_unit_rows(rng, n, d))
    valid = rng.random(n) > 0.1
    coll = rng.integers(0, 3, n).astype(np.int32)
    cid = np.resize(np.array([-1, 0, 1, 2, -2], np.int32), b)
    return rows, scales, valid, coll, cid, _unit_rows(rng, b, d)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scoped", [True, False])
@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bucket_maxima_int_rows_ragged_shapes_match_pallas(rng, kind, scoped, shape):
    """The reference kernel takes whole blocks only, so its rows are padded to one
    block of a multiple of 16 rows (pad rows masked with -inf, as its own fused
    top-k pads them); every bucket of the port must equal it bit for bit."""
    n, d, b = shape
    rows, scales, valid, coll, cid, q = _ragged_inputs(rng, kind, n, d, b)
    n_pad = -(-n // 16) * 16
    pad = n_pad - n
    addmask = np.where(np.pad(valid, (0, pad)), 0.0, -np.inf).astype(np.float32)[None, :]
    q_i8, q_scale = ref_quantize_queries(jnp.asarray(q))
    scope_j = dict(collection_of=jnp.asarray(np.pad(coll, (0, pad)))[None, :],
                   coll_cid=jnp.asarray(cid)[None, :])
    want = bucket_maxima_pallas(
        jnp.asarray(np.pad(rows, ((0, pad), (0, 0)))), q_i8, jnp.asarray(addmask),
        scales=jnp.asarray(np.pad(scales, (0, pad), constant_values=1.0))[None, :],
        q_scale=q_scale.T, block=n_pad, bucket=16, interpret=True, **(scope_j if scoped else {}),
    )
    t_q, t_qs = port.quantize_queries_int8(torch.from_numpy(q))
    t_rows, t_scales, t_valid, t_coll, t_cid = _t(rows, scales, valid, coll, cid)
    got = port_fused.bucket_maxima(
        t_rows, t_q, t_valid, t_coll if scoped else None, t_cid if scoped else None,
        scales=t_scales, q_scale=t_qs,
    )
    assert got.shape == (b, n_pad // 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _numpy_bucket_maxima(kind, rows, scales, q_i8, q_scale, mask):
    """int64 dot, then the two float32 multiplies in the kernel's order."""
    if kind == "int4":
        low = ((rows & 0xF).astype(np.int64) ^ 8) - 8
        high = ((rows >> 4).astype(np.int64) ^ 8) - 8
        codes = np.concatenate([low, high], axis=1)
    else:
        codes = rows.astype(np.int64)
    acc = q_i8.astype(np.int64) @ codes.T
    s = (acc.astype(np.float32) * scales[None, :].astype(np.float32)) * q_scale.reshape(-1, 1)
    s = np.where(mask, s, -np.inf).astype(np.float32)
    n = s.shape[1]
    n_pad = -(-n // 16) * 16
    s = np.pad(s, ((0, 0), (0, n_pad - n)), constant_values=-np.inf)
    return s.reshape(s.shape[0], n_pad // 16, 16).max(axis=2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", ["scoped", "unscoped", "all_invalid"])
@pytest.mark.parametrize("shape", [(17, 160, 1), (129, 64, 257), (33, 4096, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bucket_maxima_plain_matches_numpy(rng, kind, case, shape):
    n, d, b = shape
    rows, scales, valid, coll, cid, q = _ragged_inputs(rng, kind, n, d, b)
    if case == "all_invalid":
        valid = np.zeros(n, bool)
    t_q, t_qs = port.quantize_queries_int8(torch.from_numpy(q))
    mask = np.broadcast_to(valid, (b, n))
    if case != "unscoped":
        mask = mask & ((cid[:, None] == -1) | (coll[None, :] == cid[:, None]))
    want = _numpy_bucket_maxima(kind, rows, scales, t_q.numpy(), t_qs.numpy(), mask)
    t_rows, t_scales, t_valid, t_coll, t_cid = _t(rows, scales, valid, coll, cid)
    scope = (None, None) if case == "unscoped" else (t_coll, t_cid)
    got = port_fused.bucket_maxima_plain(t_rows, t_q, t_valid, *scope, scales=t_scales, q_scale=t_qs)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "all_invalid":
        assert bool(torch.isinf(got).all())
    if case == "scoped" and b >= 5:
        assert bool(torch.isinf(got[4]).all())  # cid -2 matches nothing


def _int_args(kind, n=32, d=64, b=2):
    rows = torch.zeros((n, d // 2 if kind == "int4" else d),
                       dtype=torch.uint8 if kind == "int4" else torch.int8)
    return rows, torch.zeros((b, d), dtype=torch.int8), torch.ones(n), torch.ones((b, 1))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", ["query_width", "float_queries", "no_scales", "no_q_scale"])
def test_check_rows_raises(kind, fault):
    rows, q, scales, q_scale = _int_args(kind)
    valid = torch.ones(rows.shape[0], dtype=torch.bool)
    if fault == "query_width":  # int4: queries must be twice the packed width
        q = q[:, : q.shape[1] // 2].contiguous()
    elif fault == "float_queries":
        q = q.float()
    elif fault == "no_scales":
        scales = None
    else:
        q_scale = None
    with pytest.raises(ValueError):
        port_fused.bucket_maxima(rows, q, valid, scales=scales, q_scale=q_scale)
    with pytest.raises(ValueError):
        port_fused._check_rows(rows, q, scales, q_scale)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", ["row_bytes", "too_wide", "misaligned_rows", "misaligned_queries",
                                   "rows_on_other_device_size"])
def test_launch_checks_raise_before_any_build(monkeypatch, kind, fault):
    """What the kernels do not take (rows that are no multiple of 16 bytes, which TMA
    cannot describe; widths past the int32 sums; pointers off a 16-byte boundary; a
    mask of another length) is refused by the wrapper before a kernel is built."""
    from triple_hybrid_rag_tpu_torch.kernels import build

    def no_build(*_a, **_k):
        raise AssertionError("the launch checks must run before the kernels are built")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build", no_build)
    n, d, b = 32, 64, 2
    if fault == "row_bytes":
        d = 24 if kind == "int8" else 48  # 24 bytes a row either way
    elif fault == "too_wide":
        n, d = 1, 65536 + 32
    rows, q, scales, q_scale = _int_args(kind, n, d, b)
    valid = torch.ones(n, dtype=torch.bool)
    if fault == "misaligned_rows":
        flat = torch.zeros(rows.numel() + 16, dtype=rows.dtype)
        rows = flat[1:1 + rows.numel()].view(rows.shape)
    elif fault == "misaligned_queries":
        flat = torch.zeros(q.numel() + 16, dtype=q.dtype)
        q = flat[3:3 + q.numel()].view(q.shape)
    elif fault == "rows_on_other_device_size":
        valid = valid[:-1]
    if fault in ("row_bytes", "too_wide"):
        with pytest.raises(ValueError):
            port_fused._check_launch(rows, q)
    with pytest.raises(ValueError):
        port_fused._launch_bucket_maxima(rows, q, valid, None, None, scales, q_scale)
