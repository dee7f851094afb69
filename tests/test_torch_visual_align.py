"""The port's visual aligner (``models/visual_align.py``) against the JAX
package's, on the CPU, at a small config (32 px, patch 8, d 32, 2 layers, 4
heads, d_ff 64, out 48).

- The forward, from the reference's flax init carried over, in the reference's
  bf16 blocks over an f32 residual: within ``FORWARD_ATOL`` = 2e-3 (unit vectors;
  one bf16 rounding of a block's output lands on the residual, 3.9e-3 an ulp at
  1.0, at most half of it).
- ``image_bytes_to_grid`` and ``render_training_pair``: equal for the same seed.
- ``save_aligner`` / ``load_aligner``: bit for bit both ways.
- ``train_visual_aligner`` from the same initial weights: the logged losses (four
  decimals) within ``LOSS_ATOL`` = 2e-3 and the trained weights within
  ``PARAM_ATOL`` = 2e-3 (three Adam steps of 3e-4 each: a gradient entry that
  bf16 rounding flips the sign of moves a weight 6e-4 the other way, per step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from torch_port_helpers import flat_params
from triple_hybrid_rag_tpu.config import RAGConfig as RefConfig
from triple_hybrid_rag_tpu.models import visual_align as ref_va
from triple_hybrid_rag_tpu.models.embedder import BowHashEmbedder as RefBow
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.models import visual_align as va
from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
from triple_hybrid_rag_tpu_torch.models.encoder import encoder_params_from_flax

FORWARD_ATOL = 2e-3
LOSS_ATOL = 2e-3
PARAM_ATOL = 2e-3

SMALL = dict(image_size=32, patch=8, d_model=32, n_layers=2, n_heads=4, d_ff=64, out_dim=48)
TEXTS = [
    "Return the sum of the elements of the iterable, starting from the given value.",
    "Open the file and return a stream object; raise an error when it cannot be opened.",
    "Split the string at each separator and return a list of the words it contains.",
    "Convert the timestamp to a local date and time according to the system clock settings.",
    "Acme Corp settles every invoice within thirty days of the billing date by transfer.",
    "Red foxes inhabit the northern forest and hunt small rodents during the night.",
    "short text",  # fewer than six words: filtered out by both
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_init(seed: int = 0):
    cfg = ref_va.VisualAlignerConfig(**SMALL)
    return ref_va.VisualEncoder(cfg).init(jax.random.PRNGKey(seed),
                                          jnp.zeros((2, cfg.image_size, cfg.image_size)))


def test_config_equals_reference():
    assert dataclasses.asdict(va.VisualAlignerConfig()) == dataclasses.asdict(
        ref_va.VisualAlignerConfig())
    assert set(ref_va.__all__) <= set(va.__all__)


def test_forward_matches_flax():
    params = flax_init()
    x = np.random.default_rng(0).random((5, 32, 32)).astype(np.float32)
    x[0] = 0.5  # a flat image: every patch's deviation is below the 1e-3 floor
    want = np.asarray(ref_va.VisualEncoder(ref_va.VisualAlignerConfig(**SMALL)).apply(
        params, jnp.asarray(x)))
    model = va.VisualEncoder(va.VisualAlignerConfig(**SMALL))
    model.load_state_dict(encoder_params_from_flax(flat_params(params)))
    assert model.blocks[0].dtype == torch.bfloat16  # the reference's default compute dtype
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (5, 48)
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


def test_grids_and_renders_equal_reference():
    from triple_hybrid_rag_tpu_torch.ocr_glyph import render_text_image

    png = render_text_image("Invoice 2041 total due", width=300)
    np.testing.assert_array_equal(va.image_bytes_to_grid(png, 40), ref_va.image_bytes_to_grid(png, 40))
    assert va.image_bytes_to_grid(b"not an image") is None
    assert ref_va.image_bytes_to_grid(b"not an image") is None
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for text in TEXTS[:4] + [""]:
        a, b = va.render_training_pair(text, r1, 48), ref_va.render_training_pair(text, r2, 48)
        if b is None:
            assert a is None
        else:
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_save_and_load_both_ways(tmp_path):
    params = flax_init(3)
    rcfg = ref_va.VisualAlignerConfig(**SMALL)
    ref_path = str(tmp_path / "ref.npz")
    ref_va.save_aligner(params, rcfg, ref_path)
    loaded = va.load_aligner(ref_path)
    assert loaded is not None and loaded[1] == va.VisualAlignerConfig(**SMALL)
    want = encoder_params_from_flax(flat_params(params))
    assert set(loaded[0]) == set(want)
    for k, t in want.items():
        assert torch.equal(loaded[0][k], t), k
    port_path = str(tmp_path / "port.npz")
    va.save_aligner(loaded[0], loaded[1], port_path)
    back, cfg = ref_va.load_aligner(port_path)
    assert cfg == rcfg
    for k, a in flat_params(params).items():
        np.testing.assert_array_equal(flat_params(back)[k], a, err_msg=k)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
    assert va.load_aligner(str(tmp_path / "absent.npz")) is None
    with pytest.raises(ValueError, match="JAX package"):
        va.save_aligner(loaded[0], loaded[1])  # the default path is the reference's
    bad = dict(loaded[0])
    bad["proj.weight"] = bad["proj.weight"][:4]
    va.save_aligner(bad, loaded[1], str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="shape"):
        va.load_aligner(str(tmp_path / "bad.npz"))


def test_training_matches_reference(monkeypatch):
    """Three steps of ``train_visual_aligner`` from the reference's initial weights
    (the port's init is flax's in distribution only, so the test hands it the
    same draw) against a bow-hash text embedder of width out_dim."""
    params = flax_init(0)
    monkeypatch.setattr(va, "init_visual_encoder", lambda cfg, seed, device=None: _carried(params))
    logs_ref, logs = [], []
    kw = dict(cfg=None, steps=3, batch=4, seed=0, renders_per_text=2)
    want, rcfg = ref_va.train_visual_aligner(
        TEXTS, RefBow(48, RefConfig()), **{**kw, "cfg": ref_va.VisualAlignerConfig(**SMALL)},
        log=logs_ref.append)
    got, cfg = va.train_visual_aligner(
        TEXTS, BowHashEmbedder(48, RAGConfig()), **{**kw, "cfg": va.VisualAlignerConfig(**SMALL)},
        log=logs.append, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert [x for x in logs if "step" not in x] == [x for x in logs_ref if "step" not in x]
    losses = [float(x.split()[-1]) for x in logs if "step" in x]
    losses_ref = [float(x.split()[-1]) for x in logs_ref if "step" in x]
    assert len(losses) == len(losses_ref) == 2  # steps 0 and 2
    np.testing.assert_allclose(losses, losses_ref, atol=LOSS_ATOL, rtol=0)
    for k, t in encoder_params_from_flax(flat_params(want)).items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)


def _carried(params):
    model = va.VisualEncoder(va.VisualAlignerConfig(**SMALL))
    model.load_state_dict(encoder_params_from_flax(flat_params(params)))
    return model


def test_init_is_seeded_and_flax_shaped():
    a = va.init_visual_encoder(va.VisualAlignerConfig(**SMALL), seed=1, device="cpu").state_dict()
    b = va.init_visual_encoder(va.VisualAlignerConfig(**SMALL), seed=1, device="cpu").state_dict()
    want = encoder_params_from_flax(flat_params(flax_init(1)))
    for k, t in want.items():
        assert a[k].shape == t.shape and torch.equal(a[k], b[k]), k
        if float(t.std()) > 0:
            assert abs(float(a[k].std()) / float(t.std()) - 1) < 0.25, k  # 16x32 draws at the least


def test_embedder_embeds_images_and_grids():
    """``VisualAlignEmbedder`` at the aligner's width equals the reference's. Below
    it the port truncates and renormalizes (Matryoshka); the reference's in-place
    division of a read-only array raises there (ROADMAP.md, Queue 3), so its
    embedder rung falls back to the perceptual features."""
    from triple_hybrid_rag_tpu_torch.ocr_glyph import render_text_image

    params = flax_init(2)
    state = encoder_params_from_flax(flat_params(params))
    png = render_text_image("Freight manifest for container 7", width=320)
    emb = va.VisualAlignEmbedder(state, va.VisualAlignerConfig(**SMALL), device="cpu")
    ref = ref_va.VisualAlignEmbedder(params, ref_va.VisualAlignerConfig(**SMALL))
    got, want = emb.embed_image_bytes(png), ref.embed_image_bytes(png)
    assert got.shape == (48,)
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)
    assert emb.embed_image_bytes(b"junk") is None
    short = va.VisualAlignEmbedder(state, va.VisualAlignerConfig(**SMALL), out_dim=32, device="cpu")
    cut = short.embed_image_bytes(png)
    np.testing.assert_allclose(cut, got[:32] / np.linalg.norm(got[:32]), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="read-only"):
        ref_va.VisualAlignEmbedder(params, ref_va.VisualAlignerConfig(**SMALL),
                                   out_dim=32).embed_image_bytes(png)
