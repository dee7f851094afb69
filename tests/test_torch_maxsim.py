"""The port's MaxSim scores (plain path of ``csrc/maxsim.cu``) against the JAX
einsum op and the Pallas kernel in interpret mode: atol 1e-6 (the same bf16
products, f32 sums in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from triple_hybrid_rag_tpu.ops.maxsim import calibrate_maxsim as ref_cal
from triple_hybrid_rag_tpu.ops.maxsim import dequantize_tokens as ref_deq
from triple_hybrid_rag_tpu.ops.maxsim import maxsim_scores as ref_maxsim
from triple_hybrid_rag_tpu.ops.pallas import maxsim_scores_pallas
from triple_hybrid_rag_tpu_torch.ops import maxsim as port


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
