"""The port's dp x tp training mesh (``models/training.py``) against the JAX
package's sharded step and against the port's own unsharded step, on the CPU.

The reference shards its step over the suite's 8 virtual CPU devices
(``tests/conftest.py``); the port runs the same dp 4 x tp 2 fold over
``devices=["cpu"] * 8`` in one process. At ``tests/test_torch_training.py``'s small
configuration and batches, from the reference's initial parameters. The
tolerances, that file's:

- three sharded steps: losses within ``LOSS_RTOL`` = 1e-4 of the port's unsharded
  steps and of the reference's sharded steps, accuracies within one example in 16
  (row-parallel products add their partial sums in another order);
- the weights after the steps within ``WARM_ATOL`` = 2e-3 of the unsharded run's
  (an Adam step moves a weight by up to the learning rate, and a gradient entry
  near zero can take either sign);
- after step 0 (learning rate 0) the weights are bit-equal to the start, and the
  AdamW moments of a piece equal that block of the unsharded moments within
  1e-6 relative to the largest.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import LOSS_RTOL, TC, WARM_ATOL, batches, carried, configs
from triple_hybrid_rag_tpu.config import get_settings as ref_settings
from triple_hybrid_rag_tpu.models import encoder as ref_enc
from triple_hybrid_rag_tpu.models import pretrain as ref_pre
from triple_hybrid_rag_tpu.models import training as ref_tr
from triple_hybrid_rag_tpu_torch.config import get_settings
from triple_hybrid_rag_tpu_torch.models import encoder as enc
from triple_hybrid_rag_tpu_torch.models import training as tr

CPU8 = ["cpu"] * 8
TINY = dict(vocab_buckets=512, d_model=32, n_layers=2, n_heads=4, d_mlp=64, max_tokens=16,
            out_dim=32, token_dim=16, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unsharded_copy(model, state):
    """A second port model and state with the same weights and a fresh optimizer."""
    m = copy.deepcopy(model)
    return m, tr.TrainState(model=m, opt_state=state.tx.init(dict(m.named_parameters())),
                            tx=state.tx)


def test_training_mesh_shape():
    mesh = tr.training_mesh(tp=2, devices=CPU8)
    assert mesh.shape == dict(ref_tr.training_mesh(tp=2).shape) == {"dp": 4, "tp": 2}
    assert tr.training_mesh(tp=16, devices=CPU8).shape == {"dp": 1, "tp": 8}
    assert tr.training_mesh(n_devices=4, tp=2, devices=CPU8).shape == {"dp": 2, "tp": 2}


def test_param_sharding_layout():
    """The reference's ``test_param_sharding_layout``: TINY's ``mlp_in`` splits over
    2-way tp into (32, 32) pieces; the layout follows ``_param_spec``."""
    mesh = tr.training_mesh(tp=2, devices=CPU8)
    model, state = tr.create_train_state(enc.EncoderConfig(**TINY), mesh=mesh, device="cpu")
    pieces = state.pieces["blocks.0.mlp_in.weight"]
    assert [tuple(p.shape) for p in pieces] == [(32, 32), (32, 32)]
    specs = tr.param_shardings(model, mesh)
    assert specs["blocks.0.mlp_in.weight"] == ("tp", None)
    assert specs["blocks.0.mlp_out.weight"] == (None, "tp")
    assert specs["blocks.1.attn.query.weight"] == ("tp", None)
    assert specs["blocks.1.attn.out.weight"] == (None, "tp")
    assert specs["pool_proj.weight"] == specs["token_proj.weight"] == ("tp", None)
    assert specs["tok_embed"] == specs["blocks.0.mlp_in.bias"] == specs["ln_final.scale"] == ()
    # replicated parameters are one piece; the moments are placed like the pieces
    assert len(state.pieces["tok_embed"]) == 1
    assert {k: tuple(v.shape) for k, v in state.opt_state.mu.items()} == {
        k: tuple(v.shape) for k, v in state.params().items()}


def test_three_sharded_steps_match_unsharded_and_reference():
    rmodel, rstate, model, state = carried()
    model1, state1 = unsharded_copy(model, state)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    mesh = tr.training_mesh(tp=2, devices=CPU8)
    state = tr.shard_train_state(state, mesh)
    step = tr.make_train_step(model, tr.TrainConfig(**TC), mesh)
    step1 = tr.make_train_step(model1, tr.TrainConfig(**TC))
    rmesh = ref_tr.training_mesh(tp=2)
    rstate = ref_tr.shard_train_state(rstate, rmesh)
    rstep = ref_tr.make_train_step(rmodel, ref_tr.TrainConfig(**TC), rmesh)
    got, one, want = [], [], []
    for i, arrs in enumerate(batches(3, seed=4)):
        state, m = step(state, *[torch.from_numpy(a) for a in arrs])
        state1, m1 = step1(state1, *[torch.from_numpy(a) for a in arrs])
        rstate, mr = rstep(rstate, *[jnp.asarray(a) for a in arrs])
        got.append((float(m["loss"]), float(m["accuracy"])))
        one.append((float(m1["loss"]), float(m1["accuracy"])))
        want.append((float(mr["loss"]), float(mr["accuracy"])))
        if i == 0:  # lr 0: the weights stay, the moments are the unsharded ones' blocks
            for k, p in model.named_parameters():
                assert torch.equal(p.detach(), start[k]), k
            mu1 = state1.opt_state.mu["blocks.0.mlp_in.weight"]
            pieces = [state.opt_state.mu[f"blocks.0.mlp_in.weight[{c}]"] for c in range(2)]
            torch.testing.assert_close(torch.cat(pieces, 0), mu1, rtol=0,
                                       atol=1e-6 * float(mu1.abs().max()))
    assert state.step == 3
    for ref in (one, want):
        np.testing.assert_allclose([g[0] for g in got], [w[0] for w in ref], rtol=LOSS_RTOL)
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in ref], atol=1 / 16 + 1e-9)
    gap = max(float((p.detach() - q.detach()).abs().max())
              for p, q in zip(model.parameters(), model1.parameters()))
    assert gap <= WARM_ATOL, gap


@pytest.mark.parametrize("n", [6, 3])
def test_batch_that_dp_does_not_divide_raises(n):
    """A batch of 6 or 3 on dp = 4 raises. The reference's GSPMD step takes it, but
    its parameters come out NaN (checked here at 6), so the port refuses it."""
    rmodel, rstate, model, state = carried()
    mesh = tr.training_mesh(tp=2, devices=CPU8)
    state = tr.shard_train_state(state, mesh)
    step = tr.make_train_step(model, tr.TrainConfig(**TC), mesh)
    arrs = [a[:n] for a in batches(1, seed=2)[0]]
    with pytest.raises(ValueError, match="does not split over dp"):
        step(state, *[torch.from_numpy(a) for a in arrs])
    if n != 6:  # one reference compile is evidence enough
        return
    rmesh = ref_tr.training_mesh(tp=2)
    rstep = ref_tr.make_train_step(rmodel, ref_tr.TrainConfig(**TC), rmesh)
    rstate, _ = rstep(ref_tr.shard_train_state(rstate, rmesh), *[jnp.asarray(a) for a in arrs])
    assert any(np.isnan(np.asarray(x)).any() for x in jax.tree_util.tree_leaves(rstate.params))


def test_train_pairs_over_a_mesh_matches_reference():
    """``train_pairs(mesh=)`` (batches of 4 over dp 2 x tp 2, a dropped 1-pair tail)
    from the same initial parameters: the final metrics agree with the reference's
    sharded run; the model holds the trained weights. Batches of 5 raise."""
    rmodel, rstate, model, state = carried()
    rcfg, pcfg = configs()
    pairs = ref_pre.make_pairs(9, np.random.default_rng(8))
    rmesh = ref_tr.training_mesh(n_devices=4, tp=2)
    _, want = ref_tr.train_pairs(
        rmodel, ref_tr.shard_train_state(rstate, rmesh), ref_enc.TextHasher(rcfg, ref_settings()),
        pairs, ref_tr.TrainConfig(**TC), batch_size=4, epochs=2, mesh=rmesh)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    mesh = tr.training_mesh(n_devices=4, tp=2, devices=CPU8)
    state, got = tr.train_pairs(model, state, enc.TextHasher(pcfg, get_settings()), pairs,
                                tr.TrainConfig(**TC), batch_size=4, epochs=2, mesh=mesh,
                                device="cpu")
    assert state.step == 4 and state.mesh is mesh
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 4 + 1e-9
    assert any(not torch.equal(p.detach(), start[k]) for k, p in model.named_parameters())
    with pytest.raises(ValueError, match="does not split over dp"):
        tr.train_pairs(model, state, enc.TextHasher(pcfg, get_settings()), pairs,
                       tr.TrainConfig(**TC), batch_size=5, mesh=mesh, device="cpu")
