"""The port's MaxSim scores (plain path of ``csrc/maxsim.cu``) against the JAX
einsum op and the Pallas kernel in interpret mode, with bf16 and int8 token
stores: atol 1e-6 (the same bf16 products, f32 sums in another order)."""

import numpy as np
import jax
import pytest
import jax.numpy as jnp
import torch

from triple_hybrid_rag_tpu.ops.maxsim import calibrate_maxsim as ref_cal
from triple_hybrid_rag_tpu.ops.maxsim import dequantize_tokens as ref_deq
from triple_hybrid_rag_tpu.ops.maxsim import maxsim_scores as ref_maxsim
from triple_hybrid_rag_tpu.ops.pallas import maxsim_scores_pallas
from triple_hybrid_rag_tpu_torch.kernels.build import CSRC, SIGNATURES, launch_counts
from triple_hybrid_rag_tpu_torch.ops import maxsim as port


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _data(rng, p=12, td=40, d=32, b=3, k=5, tq=8):
    tokens = _unit(rng, (p, td, d))
    mask = rng.random((p, td)) > 0.2
    mask[4] = False  # a parent without any token
    parent = rng.integers(0, p, size=(b, k))
    parent[0, 1] = 4
    parent[1, 3] = -1  # invalid candidate
    q = _unit(rng, (b, tq, d)).astype(np.float16).astype(np.float32)  # f16 query wire
    w = np.ones((b, tq), np.float32)
    w[:, -2:] = 0.0
    w[:, 2] = 0.25
    return tokens, mask, parent, q, w


def _port(tokens, mask, parent, q, w):
    return port.maxsim_scores(
        torch.from_numpy(tokens).to(torch.bfloat16), torch.from_numpy(mask),
        torch.from_numpy(parent), torch.from_numpy(q), torch.from_numpy(w),
    ).numpy()


def test_matches_xla_einsum(rng):
    tokens, mask, parent, q, w = _data(rng)
    safe = np.clip(parent, 0, tokens.shape[0] - 1)
    want = jax.vmap(ref_maxsim)(
        jnp.asarray(tokens[safe], jnp.bfloat16), jnp.asarray(mask[safe]),
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(parent >= 0),
    )
    got = _port(tokens, mask, parent, q, w)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    assert got[1, 3] == 0.0 and got[0, 1] == 0.0  # invalid / no doc tokens


def test_matches_pallas_kernel(rng):
    tokens, mask, parent, q, w = _data(rng, td=160)  # > one 128-token tile
    safe = np.clip(parent, 0, tokens.shape[0] - 1)
    got = _port(tokens, mask, parent, q, w)
    for i in range(parent.shape[0]):
        want = maxsim_scores_pallas(
            jnp.asarray(tokens[safe[i]]), jnp.asarray(mask[safe[i]]), jnp.asarray(q[i]),
            jnp.asarray(w[i]), jnp.asarray(parent[i] >= 0), interpret=True,
        )
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-6, rtol=0)


def test_all_masked_doc(rng):
    tokens, mask, parent, q, w = _data(rng)
    mask[:] = False
    assert np.all(_port(tokens, mask, parent, q, w) == 0.0)


def test_calibrate_and_dequantize(rng):
    s = rng.random(16).astype(np.float32)
    for cal in (0.6, 1.0, 0.0):
        np.testing.assert_array_equal(
            np.asarray(ref_cal(jnp.asarray(s), cal)), port.calibrate_maxsim(torch.from_numpy(s), cal).numpy()
        )
    i8 = rng.integers(-127, 128, size=(4, 8)).astype(np.int8)
    want = np.asarray(ref_deq(jnp.asarray(i8)).astype(jnp.float32))
    np.testing.assert_array_equal(port.dequantize_tokens(torch.from_numpy(i8)).float().numpy(), want)


# ---- the int8 token store: scored as the reference scores it, never widened ----

from triple_hybrid_rag_tpu.index.maxsim_index import _pack_tokens  # noqa: E402
from triple_hybrid_rag_tpu.ops.pallas.maxsim_kernel import T_TILE  # noqa: E402

SHAPES = [(td, d, tq) for td in (40, 130) for d in (32, 40, 64, 128) for tq in (1, 16, 32)]


def _int8_data(rng, td, d, tq, p=9, b=2, k=6):
    """As _data, with int8 tokens (the reference's rule), any Tq and a candidate
    past the store (clamped to its last row, as the reference clips)."""
    tokens = _pack_tokens(_unit(rng, (p, td, d)), "int8")
    mask = rng.random((p, td)) > 0.2
    mask[4] = False  # a parent without any token
    mask[-1, 0] = True
    parent = rng.integers(0, p - 1, size=(b, k))
    parent[0, 1] = 4
    parent[1, 3] = -1  # invalid candidate
    parent[1, 0] = p + 3
    q = _unit(rng, (b, tq, d)).astype(np.float16).astype(np.float32)  # f16 query wire
    w = np.ones((b, tq), np.float32)
    w[:, tq // 2:] = 0.25 if tq > 1 else 1.0
    w[:, tq - tq // 4:] = 0.0 if tq > 3 else w[:, tq - tq // 4:]
    return tokens, mask, parent, q, w


@pytest.mark.parametrize("td,d,tq", SHAPES)
def test_int8_store_matches_xla_einsum(rng, td, d, tq):
    """MaxSimIndex.score_candidates with use_pallas False on the same int8 rows."""
    tokens, mask, parent, q, w = _int8_data(rng, td, d, tq)
    safe = np.clip(parent, 0, tokens.shape[0] - 1)
    want = jax.vmap(ref_maxsim)(
        jnp.asarray(tokens[safe]), jnp.asarray(mask[safe]), jnp.asarray(q), jnp.asarray(w),
        jnp.asarray(parent >= 0),
    )
    got = port.maxsim_scores(
        torch.from_numpy(tokens), torch.from_numpy(mask), torch.from_numpy(parent),
        torch.from_numpy(q), torch.from_numpy(w),
    ).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    assert got[1, 3] == 0.0 and got[0, 1] == 0.0  # invalid / no doc tokens
    assert np.all(got[1:, 0] > 0)  # the clamped candidate scores the last parent


@pytest.mark.parametrize("td,d,tq", [(40, 32, 1), (130, 40, 16), (40, 64, 32), (130, 128, 32)])
def test_int8_store_matches_pallas_kernel(rng, td, d, tq):
    """MaxSimIndex.score_candidates with use_pallas True: the Pallas kernel in
    interpret mode on dequantize_tokens of the gathered rows (Td not a multiple of
    its T_TILE)."""
    assert td % T_TILE
    tokens, mask, parent, q, w = _int8_data(rng, td, d, tq)
    safe = np.clip(parent, 0, tokens.shape[0] - 1)
    got = port.maxsim_scores(
        torch.from_numpy(tokens), torch.from_numpy(mask), torch.from_numpy(parent),
        torch.from_numpy(q), torch.from_numpy(w),
    ).numpy()
    for i in range(parent.shape[0]):
        want = maxsim_scores_pallas(
            ref_deq(jnp.asarray(tokens[safe[i]])).astype(jnp.bfloat16), jnp.asarray(mask[safe[i]]),
            jnp.asarray(q[i]), jnp.asarray(w[i]), jnp.asarray(parent[i] >= 0), interpret=True,
        )
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-6, rtol=0)


def test_int8_store_all_masked(rng):
    tokens, mask, parent, q, w = _int8_data(rng, 40, 32, 16)
    mask[:] = False
    got = port.maxsim_scores(
        torch.from_numpy(tokens), torch.from_numpy(mask), torch.from_numpy(parent),
        torch.from_numpy(q), torch.from_numpy(w),
    )
    assert torch.all(got == 0.0)


@pytest.mark.parametrize("embedding_dtype", ["int8", "int4"])
@pytest.mark.parametrize("source", [np.float32, np.float16])
def test_quantize_tokens_is_the_reference_rule(rng, embedding_dtype, source):
    """quantize_tokens equals the reference's _pack_tokens bit for bit (int4 dense
    keeps int8 tokens), rounding ties and the clip at +-127 included."""
    x = _unit(rng, (5, 7, 32)).astype(source)
    x[0, 0, :4] = [0.5 / 127, -1.5 / 127, 1.0, -1.0]  # ties to even, the clip
    x[0, 1, :2] = [1.01, -1.02]
    want = _pack_tokens(x.astype(np.float32), embedding_dtype)
    got = port.quantize_tokens(torch.from_numpy(x))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)


# ---- past the CUDA kernel's staged plan: more than 128 query tokens, wide tokens ----

WIDE = [(40, 1024, 129), (40, 1024, 256), (40, 2048, 16)]


@pytest.mark.parametrize("store", ["bf16", "int8"])
@pytest.mark.parametrize("td,d,tq", WIDE)
def test_wide_shapes_match_einsum_and_pallas(rng, store, td, d, tq):
    """Tq of 129 and 256 and D of 1024 and 2048, where the kernel's wrapper raised
    before its general plan: the port against the einsum op and the Pallas kernel
    in interpret mode, as at the served shapes."""
    if store == "bf16":
        tokens, mask, parent, q, w = _data(rng, p=6, td=td, d=d, tq=tq)
        ref_tokens, port_tokens = jnp.asarray(tokens, jnp.bfloat16), torch.from_numpy(tokens).to(torch.bfloat16)
    else:
        tokens, mask, parent, q, w = _int8_data(rng, td, d, tq, p=6)
        ref_tokens, port_tokens = jnp.asarray(tokens), torch.from_numpy(tokens)
    safe = np.clip(parent, 0, tokens.shape[0] - 1)
    got = port.maxsim_scores(
        port_tokens, torch.from_numpy(mask), torch.from_numpy(parent), torch.from_numpy(q),
        torch.from_numpy(w),
    ).numpy()
    want = jax.vmap(ref_maxsim)(
        ref_tokens[safe], jnp.asarray(mask[safe]), jnp.asarray(q), jnp.asarray(w),
        jnp.asarray(parent >= 0),
    )
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    assert got[1, 3] == 0.0 and got[0, 1] == 0.0  # invalid / no doc tokens
    for i in range(parent.shape[0]):
        want_i = maxsim_scores_pallas(
            ref_deq(ref_tokens[safe[i]]).astype(jnp.bfloat16), jnp.asarray(mask[safe[i]]),
            jnp.asarray(q[i]), jnp.asarray(w[i]), jnp.asarray(parent[i] >= 0), interpret=True,
        )
        np.testing.assert_allclose(got[i], np.asarray(want_i), atol=1e-6, rtol=0)



def _c_exports(source: str) -> dict:
    """name -> parameter count of each ``int name(...)`` in a source's extern "C" block."""
    import re

    block = source[source.index('extern "C" {'):]
    return {m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
            for m in re.finditer(r"\nint (\w+)\(([^)]*)\)", block)}


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in SIGNATURES.items() for fn in fns])
def test_kernel_exports_match_their_ctypes_signatures(lib, fn):
    """Every function ``kernels/build.py`` binds is exported by its source with as
    many parameters as its ctypes signature declares (a mismatch would pass
    pointers in the wrong slots on the card)."""
    exports = _c_exports((CSRC / f"{lib}.cu").read_text())
    assert exports.get(fn) == len(SIGNATURES[lib][fn])


def test_maxsim_plan_names_and_counters(rng):
    """The plan names are the launcher's PlanKind order; a CPU store takes the plain
    version and counts no launch, by kernel or by plan."""
    assert port.PLANS == ("staged", "wgmma", "general")
    tokens, mask, parent, q, w = (torch.from_numpy(x) for x in _data(rng, tq=200, d=64))
    before = launch_counts(), launch_counts(by="plan")
    assert port.maxsim_plan(tokens.to(torch.bfloat16), parent, q) == "plain"
    port.maxsim_scores(tokens.to(torch.bfloat16), mask, parent, q, w)
    assert (launch_counts(), launch_counts(by="plan")) == before
    text = (CSRC / "maxsim.cu").read_text()
    assert "enum PlanKind { kPlanStaged = 0, kPlanWgmma = 1, kPlanGeneral = 2 };" in text
