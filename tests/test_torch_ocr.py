"""The port's OCR (tiling, merges, confidence, the mode ladder, the glyph recognizer,
the recognizer ladder) and the embedders' image path against the JAX reference's,
on the CPU.

The inputs are those of the reference's ``tests/test_ocr.py``, ``test_ocr_glyph.py``
and ``test_embedder.py``. Geometry, merges, confidences and OCR results must be
equal; ``GlyphOCR`` must give the same text and confidence for the same rendered
image (both packages build the atlas from this machine's PIL font).
``embed_images`` and ``embed_mixed`` of the hash and bow-hash embedders are equal
bit for bit (OCR'd text, perceptual features, content hash); the encoder's within
1e-5, the f32 forward's tolerance of ``tests/test_torch_encoder.py``; through a
visual aligner's weights within 2e-3 (its bf16 blocks). A scanned
page ingests through both facades' default OCR ladder and is found by its text
with equal ids.
"""

import dataclasses
import io
import struct

import numpy as np
import pytest

pytest.importorskip("PIL")

from triple_hybrid_rag_tpu import ocr as ref_ocr
from triple_hybrid_rag_tpu import ocr_glyph as ref_glyph
from triple_hybrid_rag_tpu.config import RAGConfig as RefConfig
from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.models import embedder as ref_embedder

from test_torch_encoder import carried
from test_torch_staged import _compare
from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch import ocr, ocr_glyph
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.models import embedder

ENCODER_ATOL = 1e-5
# the aligner's bf16 blocks (tests/test_torch_visual_align.py's forward tolerance)
ALIGNER_ATOL = 2e-3


def make_png(w, h):
    return b"\x89PNG\r\n\x1a\n" + b"\x00\x00\x00\rIHDR" + struct.pack(">II", w, h) + b"\x00" * 16


_JPEG = (b"\xff\xd8\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" + b"\x00" * 10 + b"\xff\xff"
         + b"\xff\xc0" + struct.pack(">H", 17) + b"\x08" + struct.pack(">HH", 600, 800) + b"\x00" * 10)
_WEBP_VP8X = b"RIFF\x00\x00\x00\x00WEBPVP8X" + b"\x00" * 8 + (1999).to_bytes(3, "little") + (
    1499).to_bytes(3, "little")
IMAGES = {
    "png": make_png(640, 480), "jpeg": _JPEG, "gif": b"GIF89a" + struct.pack("<HH", 320, 200),
    "webp-vp8x": _WEBP_VP8X, "garbage": b"garbage", "short-png": b"\x89PNG\r\n\x1a\n",
}
TILINGS = [
    ({}, (800, 600)), ({}, (2000, 1500)), ({}, (1600, 800)), ({}, (800, 1500)),
    ({"max_tiles": 4}, (5000, 5000)), ({"max_tiles": 2}, (5000, 300)),
    ({"tile_px": 512, "overlap_px": 600}, (1600, 1700)), ({"max_tiles": 1}, (3000, 3000)),
]
TEXTS = [
    "The quarterly payment schedule requires settlement in thirty days.",
    "@@## $$ %% ^^ && 11 22 !!", "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa", "", "   ",
    "Счёт оплачен полностью", "12345 67890", "x\x00\x01y",
]
MERGE_INPUTS = [
    ["The payment schedule is quarterly.\nAlpha content about invoices.",
     "The payment schedule is quarterly!\nCompletely different words here."],
    ["a", "", "b"],
    ["line one\nline two\n\nline three", "line two\nline four", "  \nline one"],
]
VOTES = [
    [("The payment schedule is qvarterly.", 0.4), ("The payment schedule is quarterly.", 0.9)],
    [("alpha beta gamma", 0.8), ("delta", 0.1), ("alpha beta gamna", 0.5)],
]
GLYPH_TEXTS = [
    "INVOICE 2041 TOTAL DUE 14900\nPayment due within thirty days",
    "Quarterly billing report for Acme Corp\nFreight shipments clear customs first\n"
    "Line three has numbers 123456",
    "Customs cleared the freight shipment",
    " ",
]


def _result(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("name", list(IMAGES))
def test_image_size_matches_reference(name):
    assert ocr.image_size(IMAGES[name]) == ref_ocr.image_size(IMAGES[name])


@pytest.mark.parametrize("kw,size", TILINGS, ids=range(len(TILINGS)))
def test_tiling_matches_reference(kw, size):
    cfg, ref_cfg = ocr.GundamTilingConfig(**kw), ref_ocr.GundamTilingConfig(**kw)
    assert ocr.should_use_gundam_tiling(*size, cfg) == ref_ocr.should_use_gundam_tiling(*size, ref_cfg)
    assert ocr.calculate_tiles(*size, cfg) == ref_ocr.calculate_tiles(*size, ref_cfg)


def test_confidence_and_ladder_match_reference():
    assert [ocr.estimate_confidence(t) for t in TEXTS] == [ref_ocr.estimate_confidence(t) for t in TEXTS]
    assert [ocr.next_mode(m) for m in ocr.OCR_MODES] == [ref_ocr.next_mode(m) for m in ref_ocr.OCR_MODES]


@pytest.mark.parametrize("i", range(len(MERGE_INPUTS)))
def test_merges_match_reference(i):
    texts = MERGE_INPUTS[i]
    cfg, ref_cfg = ocr.GundamTilingConfig(), ref_ocr.GundamTilingConfig()
    assert ocr.merge_concat(texts) == ref_ocr.merge_concat(texts)
    assert ocr.merge_fuzzy(texts, cfg) == ref_ocr.merge_fuzzy(texts, ref_cfg)
    if i < len(VOTES):
        assert ocr.merge_vote(VOTES[i], cfg) == ref_ocr.merge_vote(VOTES[i], ref_cfg)


def _escalating(img, mode):
    return ("@@##", 0.1) if mode == "base" else ("The clear extracted text.", 0.9)


def _exhausting(img, mode):
    return {"base": ("meh", 0.3), "large": ("better", 0.5), "gundam": ("worse", 0.2)}[mode]


def _failing(img, mode):
    if mode == "base":
        raise RuntimeError("server down")
    return "recovered text here"


def _tile_text(img, mode):
    return (f"line from {img.decode()}\nshared seam line", 0.8 if b"0, 0" in img else 0.6)


# (ocr_fn, OCRConfig kwargs, GundamTilingConfig kwargs, image size)
PROCESSORS = {
    "escalates": (_escalating, {"retry_limit": 2}, {}, (100, 100)),
    "exhausts": (_exhausting, {"confidence_threshold": 0.9}, {}, (100, 100)),
    "errors": (_failing, {}, {}, (100, 100)),
    "tiny-start": (_escalating, {"initial_mode": "tiny", "retry_limit": 1}, {}, (100, 100)),
    "gundam-concat": (_tile_text, {}, {"merge_strategy": "concat"}, (2048, 1600)),
    "gundam-fuzzy": (_tile_text, {}, {"merge_strategy": "fuzzy"}, (2048, 1600)),
    "gundam-vote": (_tile_text, {}, {"merge_strategy": "vote"}, (3000, 1600)),
}


@pytest.mark.parametrize("name", list(PROCESSORS))
def test_processor_matches_reference(name):
    fn, kw, tiling, size = PROCESSORS[name]

    def crop(img, box):
        return f"tile:{box}".encode()

    results = []
    for mod in (ref_ocr, ocr):
        cfg = mod.OCRConfig(**kw, tiling=mod.GundamTilingConfig(**tiling))
        results.append(_result(mod.OCRProcessor(fn, cfg, crop_fn=crop).process_image(make_png(*size))))
    assert results[1] == results[0]


@pytest.fixture(scope="module")
def glyphs():
    return ref_glyph.GlyphOCR(), ocr_glyph.GlyphOCR()


@pytest.mark.parametrize("i", range(len(GLYPH_TEXTS)))
def test_glyph_ocr_matches_reference(glyphs, i):
    ref, port = glyphs
    image = ocr_glyph.render_text_image(GLYPH_TEXTS[i])
    assert image == ref_glyph.render_text_image(GLYPH_TEXTS[i])
    assert [ch for ch, _ in port.atlas.templates] == [ch for ch, _ in ref.atlas.templates]
    want = ref(image)
    assert port(image) == want
    assert _result(ocr.OCRProcessor(port).process_image(image)) == _result(
        ref_ocr.OCRProcessor(ref).process_image(image))
    if GLYPH_TEXTS[i].strip():
        assert want[0] == GLYPH_TEXTS[i] and want[1] > 0.9


def test_default_ladder_matches_reference():
    """Glyph when PIL imports (one atlas a process); the HTTP vision client when
    ``ocr_api_base`` is set, one client per equal config."""
    from triple_hybrid_rag_tpu_torch.models.http_clients import HTTPVisionOCR

    fn = ocr_glyph.get_default_ocr_fn(RAGConfig())
    assert type(fn).__name__ == type(ref_glyph.get_default_ocr_fn(RefConfig())).__name__ == "GlyphOCR"
    assert ocr_glyph.get_default_ocr_fn(RAGConfig()) is fn
    cfg = RAGConfig(ocr_api_base="http://127.0.0.1:9/v1", ocr_api_model="v")
    http = ocr_glyph.get_default_ocr_fn(cfg)
    assert isinstance(http, HTTPVisionOCR) and http.model == "v"
    assert ocr_glyph.get_default_ocr_fn(cfg.replace()) is http  # equal config, same client
    assert ocr_glyph.get_default_ocr_fn(cfg.replace(ocr_api_model="w")) is not http


def _photo(seed: int, bright: float = 1.0) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = np.clip(rng.integers(0, 255, (40, 56, 3)) * bright, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _image_inputs():
    from triple_hybrid_rag_tpu_torch.ocr_glyph import render_text_image

    return [
        render_text_image("Invoice 2041 total due 14900 dollars", width=600),  # OCR -> text
        _photo(0), _photo(0, 1.2), _photo(1),  # perceptual features
        b"\x00\x01notanimage", b"\x89PNG\r\n\x1a\nnot really",  # content hash
        render_text_image("ab", width=200),  # too short to trust: perceptual
    ]


EMBEDDERS = {
    "hash": lambda: (ref_embedder.HashEmbedder(64), embedder.HashEmbedder(64)),
    "bowhash": lambda: (ref_embedder.BowHashEmbedder(64, RefConfig()),
                        embedder.BowHashEmbedder(64, RAGConfig())),
    "encoder": lambda: carried("float32"),
}


@pytest.mark.parametrize("kind", list(EMBEDDERS))
def test_embed_images_and_mixed_match_reference(kind):
    ref, port = EMBEDDERS[kind]()
    images = _image_inputs()
    atol = ENCODER_ATOL if kind == "encoder" else 0.0
    want, got = ref.embed_images(images), port.embed_images(images)
    assert got.shape == want.shape == (len(images), port.dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    # the photos and the hashed payloads take no text path: bit for bit in every embedder
    np.testing.assert_array_equal(got[1:6], want[1:6])
    assert port.embed_images([]).shape == (0, port.dim)
    items = [("text", "payment invoice overdue"), ("image", images[0]), ("text", "the of and"),
             ("image", images[1]), ("text", "")]
    np.testing.assert_allclose(port.embed_mixed(items), ref.embed_mixed(items), atol=atol, rtol=0)


def test_encoder_refuses_aligner_weights(monkeypatch, tmp_path):
    """The aligner rung against the reference's. With no aligner weights (none
    ship) the encoder takes the perceptual path in both packages; with a tiny
    aligner of the encoder's width saved at a temporary path in each package
    (the reference's file read by the port's loader and the port's by the
    reference's), ``embed_images`` embeds the photos through it in both, within
    the aligner's bf16 forward tolerance; an unreadable file disables the rung;
    a hash embedder never takes it."""
    import jax
    import jax.numpy as jnp

    from triple_hybrid_rag_tpu.models import visual_align as ref_va
    from triple_hybrid_rag_tpu_torch.models import visual_align as va

    ref, port = carried("float32")
    photos = [_photo(0), _photo(1)]
    for cls in (ref_embedder._ImageHashMixin, embedder._ImageHashMixin):
        monkeypatch.setattr(cls, "_aligner_cache", {})
    assert not __import__("os").path.exists(va.DEFAULT_ALIGNER_PATH)
    assert port._aligned_image_vec(photos[0]) is None
    perceptual = port.embed_images(photos)
    np.testing.assert_array_equal(perceptual, ref.embed_images(photos))

    cfg = dict(image_size=32, patch=8, d_model=32, n_layers=2, n_heads=4, d_ff=64, out_dim=port.dim)
    params = ref_va.VisualEncoder(ref_va.VisualAlignerConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32)))
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_va.save_aligner(params, ref_va.VisualAlignerConfig(**cfg), ref_path)
    va.save_aligner(*va.load_aligner(ref_path), port_path)
    monkeypatch.setattr(ref_va, "load_aligner", lambda path=port_path, _f=ref_va.load_aligner: _f(path))
    monkeypatch.setattr(va, "DEFAULT_ALIGNER_PATH", ref_path)
    for cls in (ref_embedder._ImageHashMixin, embedder._ImageHashMixin):
        monkeypatch.setattr(cls, "_aligner_cache", {})
    want, got = ref.embed_images(photos), port.embed_images(photos)
    np.testing.assert_allclose(got, want, atol=ALIGNER_ATOL, rtol=0)
    assert np.abs(got - perceptual).max() > 0.1  # the aligner answered, not the features
    assert embedder.BowHashEmbedder(64, RAGConfig())._aligned_image_vec(photos[0]) is None

    broken = tmp_path / "broken.npz"
    broken.write_bytes(b"")
    monkeypatch.setattr(va, "DEFAULT_ALIGNER_PATH", str(broken))
    monkeypatch.setattr(embedder._ImageHashMixin, "_aligner_cache", {})
    np.testing.assert_array_equal(port.embed_images(photos), perceptual)


def test_scanned_page_ingests_and_is_found(small_config, tmp_path):
    """``test_ocr_glyph.py``'s scanned page through both facades' default OCR
    ladder: the same page text, chunk ids and scores."""
    page = tmp_path / "scan.png"
    page.write_bytes(ocr_glyph.render_text_image(
        "Invoice 2041 total due 14900 dollars\nPayment must settle within thirty days of billing"))
    cfg = small_config.replace(graph_enabled=False, safety_threshold=0.1, embedding_dtype="float32")
    ref, port = RefRAG(config=cfg), RAG(torch_config(cfg), device="cpu")
    for r in (ref, port):
        r.ingest_text("Red foxes inhabit the northern forest.", name="w.md")
        res = r.ingest(str(page))
        assert res.status.value == "completed" and res.n_children >= 1
    texts = [[c.text for c in r.ingestor.corpus.children] for r in (ref, port)]
    assert texts[1] == texts[0] and "thirty days" in texts[0][-1]
    want, got = ref.query("invoice total due payment"), port.query("invoice total due payment")
    _compare(want, got)
    assert any("2041" in x.text for x in got.results)
