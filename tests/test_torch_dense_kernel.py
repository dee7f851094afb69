"""The port's dense-scores function (plain path of ``csrc/dense_scores.cu``) against
the Pallas kernel ``dense_scores_pallas`` in interpret mode.

Unit rows: scores agree within 1e-5 (f32 sums of the same products in another
order; with bf16 rows the products are exact in both). The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.ops.pallas import dense_scores_pallas
from triple_hybrid_rag_tpu_torch.kernels.build import launch_counts
from triple_hybrid_rag_tpu_torch.ops import dense_kernel as port


def _unit_rows(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("b", [1, 4])
def test_dense_scores_match_pallas(rng, jdt, tdt, b):
    n, d = 3000, 64  # n not a multiple of the Pallas block
    emb = _unit_rows(rng, n, d)
    q = _unit_rows(rng, b, d)
    want = np.asarray(dense_scores_pallas(jnp.asarray(emb, dtype=jdt), jnp.asarray(q), interpret=True))
    rows = torch.from_numpy(emb).to(tdt)
    got = port.dense_scores(rows, torch.from_numpy(q))  # a CPU tensor: the plain version
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert torch.equal(got, port.dense_scores_plain(rows, torch.from_numpy(q)))
    if tdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), q @ emb.T, atol=1e-5, rtol=0)


def test_dense_scores_rejects_quantized_rows():
    before = launch_counts()
    with pytest.raises(TypeError):
        port.dense_scores(torch.zeros((8, 16), dtype=torch.int8), torch.zeros((1, 16)))
    assert launch_counts() == before  # no kernel launch on the CPU


# Shapes the CUDA kernel has to get right (tiles of 128 queries x 256 rows, stages
# of 64 columns, 8-byte stores when n is even): (n, d, b).
EDGE_SHAPES = [
    (1, 64, 1),
    (77, 64, 3),  # odd n below one tile
    (127, 64, 1),
    (300, 64, 130),  # more than one tile of queries
    (257, 1024, 4),  # the serving width, one row past a tile
    (96, 1024, 130),
    (300, 72, 5),  # a width that ends inside a stage
]


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,d,b", EDGE_SHAPES)
def test_dense_scores_edge_shapes(rng, n, d, b, jdt, tdt):
    emb = _unit_rows(rng, n, d)
    q = _unit_rows(rng, b, d)
    rows = torch.from_numpy(emb).to(tdt)
    got = port.dense_scores(rows, torch.from_numpy(q))
    assert got.shape == (b, n) and got.dtype == torch.float32
    want = np.asarray(dense_scores_pallas(jnp.asarray(emb, dtype=jdt), jnp.asarray(q), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # an independent oracle: f64 products of the values both packages score
    q_cast = torch.from_numpy(q).to(tdt).double().numpy()
    np.testing.assert_allclose(got.numpy(), q_cast @ rows.double().numpy().T, atol=1e-5, rtol=0)
