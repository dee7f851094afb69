"""The port's encoder training (``models/training.py``, the rest of
``models/pretrain.py``) against the JAX package's, on the CPU.

At ``tests/test_pretrain.py``'s small configuration (vocab 2048, d 64, 2 layers,
4 heads, d_mlp 128, 12 tokens a side, out 64, token 32, Matryoshka (64, 32),
MaxSim weight 0.25, anchors on). The tolerances:

- pair generators, the mixture, the holdout: equal string for string; the BM25
  neighbour map ``array_equal``;
- the schedule: within ``SCHED_RTOL`` = 4e-7 relative at every step from 0 to
  decay_steps + 10 (about three f32 ulps: XLA's f32 cosine is not correctly
  rounded, the port's is; most steps are bit-equal);
- the gradient of one step, the reference's initial parameters carried over: per
  tensor within ``GRAD_RTOL`` = 1e-4 relative plus ``GRAD_ATOL`` = 1e-6 of the
  largest gradient entry (f32 sums in another order; the key biases' gradients are
  zero in exact arithmetic and rounding noise in both);
- AdamW updates given identical gradients: moments equal, parameters within
  ``ADAM_ATOL`` = 1e-8 (one f32 ulp of the step);
- ten steps of training: losses within ``LOSS_RTOL`` = 1e-4, accuracies within one
  example in 16;
- npz files both ways and the warm start at lr 0: bit for bit; a warm start at
  lr 2e-3 for six steps against the reference's f32 path: the final loss within
  ``LOSS_RTOL`` and the saved weights within ``WARM_ATOL`` = 2e-3 (an Adam step
  moves a weight by up to the learning rate, and a gradient entry near zero can
  take either sign; the last f16 rounding of a saved weight can differ);
- ``init_encoder``: each tensor's standard deviation within 10 % of flax's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from torch_port_helpers import flat_params
from triple_hybrid_rag_tpu.config import get_settings as ref_settings
from triple_hybrid_rag_tpu.models import encoder as ref_enc
from triple_hybrid_rag_tpu.models import pretrain as ref_pre
from triple_hybrid_rag_tpu.models import training as ref_tr
from triple_hybrid_rag_tpu_torch.config import get_settings
from triple_hybrid_rag_tpu_torch.models import encoder as enc
from triple_hybrid_rag_tpu_torch.models import pretrain as pre
from triple_hybrid_rag_tpu_torch.models import training as tr

SCHED_RTOL = 4e-7
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
ADAM_ATOL = 1e-8
LOSS_RTOL = 1e-4
WARM_ATOL = 2e-3
TOKENS = 12

SMALL = dict(vocab_buckets=2048, d_model=64, n_layers=2, n_heads=4, d_mlp=128,
             max_tokens=16, out_dim=64, token_dim=32, dtype="float32")
TC = dict(learning_rate=2e-3, warmup_steps=5, matryoshka_dims=(64, 32), maxsim_weight=0.25)

DOCS = [
    "Alpha beta gamma delta epsilon zeta eta theta. Iota kappa lambda mu nu xi omicron pi. "
    "Rho sigma tau upsilon phi chi psi omega. Payment terms settle the invoice in thirty days.",
    "One two three four five six seven eight. Nine ten eleven twelve thirteen fourteen fifteen "
    "sixteen. The invoice payment is due within thirty days of the billing date.",
    "Red foxes inhabit the northern forest and hunt small rodents at night. Bears hibernate "
    "through the winter in dens under fallen trees. Rivers carry salmon upstream each autumn.",
    "The quantum processor keeps coherence at cryogenic temperatures for error correction. "
    "Each qubit must be isolated from thermal noise by the dilution refrigerator below.",
    "Warehouse staff track every pallet and container on the shipping manifest each day. "
    "Freight carriers confirm the delivery window and the customs clearance in advance.",
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs():
    return ref_enc.EncoderConfig(**SMALL), enc.EncoderConfig(**SMALL)


def capture_grads():
    """An optax transformation that applies no update and keeps the gradients."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), {"g": u}),
    )


def carried():
    """(reference model, state) and the port's (model, state) with the same
    initial parameters (the reference's, carried over)."""
    rcfg, pcfg = configs()
    rmodel, rstate = ref_tr.create_train_state(rcfg, ref_tr.TrainConfig(**TC))
    model, state = tr.create_train_state(pcfg, tr.TrainConfig(**TC), device="cpu")
    model.load_state_dict(enc.encoder_params_from_flax(flat_params(rstate.params)))
    return rmodel, rstate, model, state


def batches(n: int, seed: int = 0, anchor_dtype=np.float32):
    """``n`` batches of 16 paraphrase pairs as numpy arrays (the reference's hasher
    and anchors; the port's are checked equal in test_torch_encoder.py)."""
    rcfg, _ = configs()
    hasher = ref_enc.TextHasher(rcfg, ref_settings())
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pairs = ref_pre.make_pairs(16, rng)
        arrs = []
        for texts in ([q for q, _ in pairs], [d for _, d in pairs]):
            ids, mask = hasher.encode(texts, max_tokens=TOKENS)
            ap, at = ref_enc.anchor_arrays(texts, rcfg, hasher.analyzer, max_tokens=TOKENS)
            arrs += [ids, mask, ap.astype(anchor_dtype), at.astype(anchor_dtype)]
        out.append(arrs)
    return out


# ------------------------------------------------------------------ pairs


def test_pair_generators_equal_reference():
    for fn in ("make_pairs", "make_overlap_pairs"):
        assert getattr(pre, fn)(40, np.random.default_rng(3)) == getattr(ref_pre, fn)(
            40, np.random.default_rng(3)), fn
    assert pre.make_realtext_pairs(30, np.random.default_rng(5), docs=DOCS, window=10) == \
        ref_pre.make_realtext_pairs(30, np.random.default_rng(5), docs=DOCS, window=10)
    assert pre._cloze_from_text("too short.", np.random.default_rng(0), 8) is None
    for name in ("DOC_TEMPLATES", "QUERY_TEMPLATES", "_GROUPS", "CONCEPTS"):
        assert getattr(pre, name) == getattr(ref_pre, name), name


def test_bm25_neighbors_and_mixture_equal_reference():
    nb = pre.bm25_neighbor_map(DOCS)
    want = ref_pre.bm25_neighbor_map(DOCS)
    assert nb.dtype == want.dtype and np.array_equal(nb, want)
    assert all(int(j) != i for i, j in enumerate(nb))
    hard = pre.make_hardneg_pairs(12, np.random.default_rng(2), DOCS, nb, window=12)
    assert hard == ref_pre.make_hardneg_pairs(12, np.random.default_rng(2), DOCS, want, window=12)
    kw = dict(overlap_frac=0.3, realtext_frac=0.35, realtext_docs=DOCS, hardneg_frac=0.2,
              realtext_window=16)
    got = pre.make_mixed_pairs(64, np.random.default_rng(9), neighbors=nb, **kw)
    assert len(got) == 64
    assert got == ref_pre.make_mixed_pairs(64, np.random.default_rng(9), neighbors=want, **kw)


def test_paraphrase_holdout_and_recall_equal_reference():
    from triple_hybrid_rag_tpu.config import RAGConfig as RefConfig
    from triple_hybrid_rag_tpu.models.embedder import BowHashEmbedder as RefBow
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder

    assert pre.make_paraphrase_holdout() == ref_pre.make_paraphrase_holdout()
    assert pre.make_paraphrase_holdout(16, seed=7) == ref_pre.make_paraphrase_holdout(16, seed=7)
    assert pre.paraphrase_recall_at_k(BowHashEmbedder(64, RAGConfig()), k=10) == \
        ref_pre.paraphrase_recall_at_k(RefBow(64, RefConfig()), k=10)


def test_configs_equal_reference():
    for name in ("default_encoder_config", "scaled_encoder_config"):
        assert dataclasses.asdict(getattr(pre, name)()) == dataclasses.asdict(
            getattr(ref_pre, name)()), name
    assert dataclasses.asdict(tr.TrainConfig()) == dataclasses.asdict(ref_tr.TrainConfig())


# ------------------------------------------------------------------ optimizer


@pytest.mark.parametrize("warmup,decay,lr", [(5, 10_000, 2e-3), (20, 100, 1e-3),
                                              (100, 2000, 1e-3), (20, 200, 1e-3)])
def test_warmup_cosine_schedule_matches_optax(warmup, decay, lr):
    want = np.asarray(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)(
        jnp.arange(decay + 11)))
    sched = tr.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    got = np.array([sched(c) for c in range(decay + 11)])
    assert got[0] == 0.0  # step 0 runs at lr 0
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)


@pytest.mark.parametrize("decay", [3, 200, 1200])
def test_cosine_schedule_matches_optax(decay):
    want = np.asarray(optax.cosine_decay_schedule(3e-4, decay)(jnp.arange(decay + 11)))
    sched = tr.cosine_decay_schedule(3e-4, decay)
    np.testing.assert_allclose([sched(c) for c in range(decay + 11)], want, rtol=SCHED_RTOL, atol=0)


@pytest.mark.parametrize("wd,warmup,decay", [(0.01, 2, 10), (1e-4, 0, 10)])
def test_adamw_update_matches_optax(wd, warmup, decay):
    """Given identical gradients, AdamW's updates equal optax's ``adamw`` at the
    encoder's weight decay and warmup-cosine schedule and at the aligner's decay
    and cosine schedule: the moments bit-equal, the parameters within ADAM_ATOL."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "b": (32,), "c": (7, 3, 5)}
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    if warmup:
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup, decay)
        mine = tr.AdamW(tr.warmup_cosine_decay_schedule(0.0, 1e-2, warmup, decay), weight_decay=wd)
    else:
        sched = optax.cosine_decay_schedule(1e-2, decay)
        mine = tr.AdamW(tr.cosine_decay_schedule(1e-2, decay), weight_decay=wd)
    tx = optax.adamw(sched, weight_decay=wd)
    st = tx.init(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = mine.init(tp)
    for i in range(4):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-5, 0)).astype(np.float32)
             for k, s in shapes.items()}
        up, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        mine.update_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert ts.count == i + 1
        for k in shapes:
            if i == 0 and warmup:
                np.testing.assert_array_equal(tp[k].numpy(), params[k])  # lr 0 at step 0
            np.testing.assert_array_equal(ts.mu[k].numpy(), np.asarray(st[0].mu[k]))
            np.testing.assert_array_equal(ts.nu[k].numpy(), np.asarray(st[0].nu[k]))
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=ADAM_ATOL)


# ------------------------------------------------------------------ loss and gradients


@pytest.mark.parametrize("anchor_dtype", [np.float32, np.float16])
def test_gradients_match_jax(anchor_dtype):
    """One step's loss, accuracy and per-tensor gradient against ``jax.grad``'s,
    through the reference's own step (an optax transformation that keeps the
    gradients), with f32 anchors (``train_pairs``) and f16 anchors
    (``train_default_encoder``)."""
    rmodel, rstate, model, state = carried()
    arrs = batches(1, anchor_dtype=anchor_dtype)[0]
    cs = train_state.TrainState.create(apply_fn=rmodel.apply, params=rstate.params,
                                       tx=capture_grads())
    new, m = ref_tr.make_train_step(rmodel, ref_tr.TrainConfig(**TC))(
        cs, *[jnp.asarray(a) for a in arrs])
    want = enc.encoder_params_from_flax(flat_params(new.opt_state["g"]))
    loss, acc = tr.contrastive_loss(model, tr.TrainConfig(**TC),
                                    *[torch.from_numpy(a) for a in arrs])
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(m["loss"]), rtol=LOSS_RTOL)
    assert float(acc) == float(m["accuracy"])
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    assert set(want) == set(params)
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * top, err_msg=name)


def test_training_blend_keeps_pooled_unnormalized_and_f16_products():
    """The training blend is not the serving blend: the pooled mix stays
    unnormalized, a padded token row stays zero with a finite gradient, and an f16
    anchor's product with its weight is rounded to f16 before the f32 sum."""
    _, cfg = configs()
    rng = np.random.default_rng(1)
    pooled = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    tok = torch.zeros(3, 4, 32, requires_grad=True)
    apool = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float16))
    atok = torch.zeros(3, 4, 32, dtype=torch.float16)
    atok[0, 0] = 0.1
    p, t = tr.training_blend(cfg, pooled, tok, apool, atok)
    a_t, b_t, a_p, b_p = enc._anchor_weights(cfg)
    want = (apool.float().numpy() * np.float16(a_p)).astype(np.float16).astype(np.float32) \
        + np.float32(b_p) * pooled.numpy()
    np.testing.assert_array_equal(p.numpy(), want)
    assert float(t[1].detach().abs().sum()) == 0.0
    t.sum().backward()
    assert torch.isfinite(tok.grad).all()


def test_ten_steps_match_reference():
    """Ten steps of ``make_train_step`` from the same initial parameters on the same
    batches: losses within LOSS_RTOL, accuracies within one example in 16."""
    rmodel, rstate, model, state = carried()
    rstep = ref_tr.make_train_step(rmodel, ref_tr.TrainConfig(**TC))
    step = tr.make_train_step(model, tr.TrainConfig(**TC))
    got, want = [], []
    for arrs in batches(10, seed=4):
        rstate, m = rstep(rstate, *[jnp.asarray(a) for a in arrs])
        state, mm = step(state, *[torch.from_numpy(a) for a in arrs])
        want.append((float(m["loss"]), float(m["accuracy"])))
        got.append((float(mm["loss"]), float(mm["accuracy"])))
    assert state.step == 10
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=LOSS_RTOL)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], atol=1 / 16 + 1e-9)


def test_training_step_learns():
    """The reference's bar (``test_pretrain.py::test_training_step_learns``): 25
    steps at lr 2e-3 bring the loss below 0.8 of the first step's."""
    _, cfg = configs()
    model, state = tr.create_train_state(cfg, tr.TrainConfig(**TC), device="cpu")
    step = tr.make_train_step(model, tr.TrainConfig(**TC))
    hasher = enc.TextHasher(cfg, get_settings())
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(25):
        pairs = pre.make_pairs(16, rng)
        q = tr.encode_batch_with_anchors(hasher, [a for a, _ in pairs], cfg, device="cpu")
        d = tr.encode_batch_with_anchors(hasher, [b for _, b in pairs], cfg, device="cpu")
        state, m = step(state, *q, *d)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_train_pairs_matches_reference():
    """``train_pairs`` (f32 anchors, a shrunk batch, a dropped 1-pair tail) from
    the same initial parameters: the final metrics agree."""
    rmodel, rstate, model, state = carried()
    rcfg, pcfg = configs()
    pairs = ref_pre.make_pairs(11, np.random.default_rng(8))
    _, want = ref_tr.train_pairs(rmodel, rstate, ref_enc.TextHasher(rcfg, ref_settings()), pairs,
                                 ref_tr.TrainConfig(**TC), batch_size=5, epochs=2)
    state, got = tr.train_pairs(model, state, enc.TextHasher(pcfg, get_settings()), pairs,
                                tr.TrainConfig(**TC), batch_size=5, epochs=2, device="cpu")
    assert state.step == 4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["accuracy"] == want["accuracy"]


def test_mesh_argument_raises():
    """A ``mesh`` is taken now (the dp x tp step: tests/test_torch_training_mesh.py),
    and a call without one is the unsharded path as before. Only a state that is not
    sharded over the step's mesh raises."""
    _, cfg = configs()
    mesh = tr.training_mesh(tp=2, devices=["cpu"] * 4)
    model, state = tr.create_train_state(cfg, mesh=mesh, device="cpu")
    assert state.mesh is mesh and state.pieces is not None
    assert {tuple(p.shape) for k, p in state.params().items() if "mlp_in.weight" in k} == {
        (cfg.d_mlp // 2, cfg.d_model)}
    step = tr.make_train_step(model, tr.TrainConfig(**TC), mesh)
    _, plain = tr.create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="not sharded"):
        step(plain, *[torch.from_numpy(a) for a in batches(1)[0]])
    # mesh-less: the model's own parameters are the state's, as before
    model2, state2 = tr.create_train_state(cfg, device="cpu")
    assert state2.mesh is None and state2.pieces is None
    assert state2.params().keys() == dict(model2.named_parameters()).keys()
    assert all(p is q for p, q in zip(state2.params().values(), model2.parameters()))


# ------------------------------------------------------------------ init and files


def test_init_matches_flax_in_distribution():
    """``init_encoder``'s per-tensor std within 10 % of flax's (constants equal)."""
    rcfg, pcfg = configs()
    _, rparams = ref_enc.init_encoder(rcfg, seed=0)
    want = enc.encoder_params_from_flax(flat_params(rparams))
    model = enc.init_encoder(pcfg, seed=0, device="cpu")
    got = dict(model.state_dict())
    assert set(got) == set(want)
    for name, t in got.items():
        w = want[name]
        assert t.dtype == torch.float32 and t.shape == w.shape, name
        sw, sg = float(w.std()), float(t.std())
        if sw == 0.0:
            np.testing.assert_array_equal(t.numpy(), w.numpy(), err_msg=name)
        else:
            assert abs(sg / sw - 1) < 0.1, (name, sg, sw)
    again = enc.init_encoder(pcfg, seed=0, device="cpu").state_dict()
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_packaged_npz_both_ways(tmp_path):
    """A port-saved npz restores bit for bit through the reference's
    ``load_encoder_params``, and a reference-saved one through the port's; both
    files hold the same names, shapes, f16 dtype and meta."""
    rcfg, pcfg = configs()
    packaged = dataclasses.replace(pcfg, dtype="bfloat16")
    model = enc.init_encoder(pcfg, seed=3, device="cpu")
    mine = pre.save_packaged_encoder(model, packaged, tmp_path / "port.npz",
                                     metrics={"loss": 1.5})
    _, template = ref_enc.init_encoder(rcfg, seed=0)
    restored = flat_params(ref_enc.load_encoder_params(template, mine))
    for name, a in enc.encoder_params_to_flax(model.state_dict(), pcfg.n_heads).items():
        np.testing.assert_array_equal(restored[name], a.astype(np.float16), err_msg=name)
        assert restored[name].dtype == np.float16
    _, rparams = ref_enc.init_encoder(rcfg, seed=5)
    theirs = ref_pre.save_packaged_encoder(rparams, ref_enc.EncoderConfig(**{**SMALL, "dtype": "bfloat16"}),
                                           tmp_path / "ref.npz", metrics={"loss": 1.5})
    with np.load(mine) as a, np.load(theirs) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert json.loads(bytes(a["__meta__"])) == json.loads(bytes(b["__meta__"]))
        want = {k: b[k] for k in b.files if k != "__meta__"}
    port = enc.Encoder(pcfg)
    pre.load_encoder_weights_(port, theirs)
    back = enc.encoder_params_to_flax(port.state_dict(), pcfg.n_heads)
    for name, a in want.items():  # widened exactly into the f32 parameters
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name].astype(np.float16), a, err_msg=name)
        np.testing.assert_array_equal(back[name], a.astype(np.float32), err_msg=name)
    emb = pre.load_default_encoder(path=theirs, device="cpu")
    # the loader re-weights the pooled anchor by RAGConfig.encoder_anchor_pool_w2
    assert emb is not None and dataclasses.replace(emb.enc_cfg, anchor_pool_w2=0.5) == packaged
    with pytest.raises(ValueError, match="JAX package"):
        pre.save_packaged_encoder(model, packaged, pre.DEFAULT_PARAMS)


def test_warm_start_at_lr_zero_keeps_weights(tmp_path):
    """``train_default_encoder`` warm-started at lr 0 leaves the f16 weights
    bit-equal, in the reference and in the port; a checkpoint of another config
    raises."""
    rcfg, pcfg = configs()
    _, rparams = ref_enc.init_encoder(rcfg, seed=1)
    packaged = ref_enc.EncoderConfig(**{**SMALL, "dtype": "bfloat16"})
    init = ref_pre.save_packaged_encoder(rparams, packaged, tmp_path / "init.npz")
    cfg = dataclasses.replace(pcfg, dtype="bfloat16")
    kw = dict(steps=2, batch_size=8, lr=0.0, realtext_frac=0.0, log_every=0,
              init_params_path=init, q_tokens=TOKENS, d_tokens=TOKENS)
    out, metrics = pre.train_default_encoder(tmp_path / "port.npz", enc_cfg=cfg, device="cpu", **kw)
    ref_out, ref_metrics = ref_pre.train_default_encoder(tmp_path / "ref.npz", enc_cfg=packaged, **kw)
    np.testing.assert_allclose(metrics["loss"], ref_metrics["loss"], rtol=LOSS_RTOL)
    with np.load(init) as a, np.load(out) as b, np.load(ref_out) as c:
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                np.testing.assert_array_equal(c[k], a[k], err_msg=k)
        meta = json.loads(bytes(b["__meta__"]))
        assert meta["encoder_config"] == dataclasses.asdict(cfg) == json.loads(
            bytes(c["__meta__"]))["encoder_config"]
    other = dataclasses.replace(cfg, d_mlp=256)
    with pytest.raises(ValueError, match="mismatch"):
        pre.train_default_encoder(tmp_path / "x.npz", enc_cfg=other, device="cpu", **kw)


def test_warm_start_trains_f32_master_weights(tmp_path, monkeypatch):
    """A warm start restores the file's f16 arrays into f32 parameters, so six steps
    at lr 2e-3 follow the reference's f32 path from the same weights (its restore
    patched to widen the arrays): the final loss within LOSS_RTOL, the saved
    weights within WARM_ATOL."""
    rcfg, pcfg = configs()
    _, rparams = ref_enc.init_encoder(rcfg, seed=2)
    packaged = ref_enc.EncoderConfig(**{**SMALL, "dtype": "bfloat16"})
    init = ref_pre.save_packaged_encoder(rparams, packaged, tmp_path / "init.npz")
    kw = dict(steps=6, batch_size=8, lr=2e-3, realtext_frac=0.0, log_every=0,
              init_params_path=init, q_tokens=TOKENS, d_tokens=TOKENS)
    out, metrics = pre.train_default_encoder(
        tmp_path / "port.npz", enc_cfg=dataclasses.replace(pcfg, dtype="bfloat16"),
        device="cpu", **kw)
    restore = ref_enc.load_encoder_params
    monkeypatch.setattr(ref_enc, "load_encoder_params", lambda t, path: jax.tree.map(
        lambda a: a.astype(jnp.float32), restore(t, path)))
    ref_out, ref_metrics = ref_pre.train_default_encoder(tmp_path / "ref.npz", enc_cfg=packaged, **kw)
    np.testing.assert_allclose(metrics["loss"], ref_metrics["loss"], rtol=LOSS_RTOL)
    moved = 0.0
    with np.load(init) as a, np.load(out) as b, np.load(ref_out) as c:
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_allclose(b[k].astype(np.float32), c[k].astype(np.float32),
                                           atol=WARM_ATOL, rtol=0, err_msg=k)
                moved = max(moved, float(np.abs(b[k].astype(np.float32) - a[k]).max()))
    assert 1e-3 < moved < 0.05  # the weights trained, by steps of about the learning rate


def test_reference_f16_warm_start_underflows_second_moments(tmp_path):
    """The reference defect the port does not copy (ROADMAP.md, Queue 3): its warm
    start keeps the file's f16 arrays as parameters, so its gradients are f16 and
    (1 - b2) g^2 underflows to zero for |g| below about 7.7e-3. A zero second
    moment leaves the first moment over eps = 1e-8: at the second step (lr 4e-4)
    the f16 path moves some weight by more than 0.1, the f32 path none by more than
    the learning rate."""
    rcfg, pcfg = configs()
    _, rparams = ref_enc.init_encoder(rcfg, seed=2)
    init = ref_pre.save_packaged_encoder(
        rparams, ref_enc.EncoderConfig(**{**SMALL, "dtype": "bfloat16"}), tmp_path / "init.npz")
    data = [[jnp.asarray(a) for a in b] for b in batches(2, anchor_dtype=np.float16)]
    zero_share, moved = {}, {}
    for dt in ("float16", "float32"):
        rmodel, rstate = ref_tr.create_train_state(rcfg, ref_tr.TrainConfig(**TC))
        params = jax.tree.map(lambda a: a.astype(dt), ref_enc.load_encoder_params(rstate.params, init))
        before = flat_params(params)
        step = ref_tr.make_train_step(rmodel, ref_tr.TrainConfig(**TC))
        rstate = rstate.replace(params=params)
        for arrs in data:
            rstate, _ = step(rstate, *arrs)
        assert jax.tree.leaves(rstate.params)[0].dtype == dt
        nu = np.asarray(rstate.opt_state[0].nu["params"]["block_0"]["mlp_in"]["kernel"])
        zero_share[dt] = float((nu == 0).mean())
        after = flat_params(rstate.params)
        moved[dt] = max(float(np.abs(after[k].astype(np.float32) - before[k]).max()) for k in before)
    assert zero_share["float16"] > 0.0 and zero_share["float32"] == 0.0, zero_share
    assert moved["float16"] > 0.1 and moved["float32"] < 1e-3, moved
    model = enc.Encoder(pcfg)
    pre.load_encoder_weights_(model, init)
    assert all(p.dtype == torch.float32 for p in model.parameters())
