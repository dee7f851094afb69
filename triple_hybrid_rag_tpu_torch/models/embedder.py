"""Hash embedders: text (and images) -> fixed-dim vectors for the dense channel and
MaxSim tokens.

Copies of the JAX package's ``HashEmbedder`` and ``BowHashEmbedder``, so a query
embeds to the same numpy vector on both sides, with its image mixin
(``_ImageHashMixin``: ``embed_images`` and ``embed_mixed``; confident OCR text embeds
as text, other images by perceptual features through a seeded projection, undecodable
ones by a content hash; all on the host). :func:`get_default_embedder` resolves
``embedder_backend`` as the reference does: "auto" and "encoder" load the trained
encoder (``models/encoder.py``) from the packaged weights. :class:`FailSoftEmbedder`
is the ingestion side's degradation ladder.
"""

from __future__ import annotations

import hashlib
import zipfile
import zlib
from typing import List, Optional, Protocol, Sequence

import numpy as np

from ..analyzer import Analyzer
from ..config import RAGConfig, get_settings


class Embedder(Protocol):
    """Pluggable embedding interface (host boundary)."""

    dim: int  # full (pre-Matryoshka) output dimension

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """f32[N, dim]; must not raise — failed items become zero vectors."""
        ...

    def embed_query(self, text: str) -> np.ndarray:
        """f32[dim]; raises on failure (reference embed_query contract)."""
        ...


def _seed_from(text: str) -> int:
    return int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")


class _ImageHashMixin:
    """Image embeddings via OCR-then-embed with a content-hash fallback (the
    reference embeds images with Qwen3-VL, core/embedder.py:141-210).

    The reference's image domain is DOCUMENT images (scanned invoices, report
    screenshots), so the semantics that matter are textual: each image runs
    through the built-in recognizer ladder (``ocr_glyph.get_default_ocr_fn`` —
    HTTP vision LLM -> pytesseract -> glyph matcher) and confident recognized
    text embeds with the SAME text embedder as the rest of the corpus, making
    image content cross-retrievable against text queries. Images with no
    recognizable text (photos, diagrams, low confidence) embed by PERCEPTUAL
    features (``_visual_image_vec``): a luminance grid + color histogram +
    gradient-energy grid projected through a fixed seeded Gaussian matrix, so
    visually similar images land near each other under cosine (near-duplicate
    and "find similar figures" retrieval) — unlike a content hash, where a
    one-pixel edit is orthogonal. Identical bytes still map to identical
    vectors (decode is deterministic), preserving dedup/self-retrieval.
    Undecodable payloads keep the content-hash unit Gaussian as last resort.
    Hermetic bound: visual features are not ALIGNED to text semantics the way
    the reference's multimodal model is — text->photo cross-modal retrieval
    needs a real vision encoder (override ``embed_images`` or use the HTTP
    embedder adapter)."""

    dim: int

    _OCR_MIN_CONF = 0.4
    _OCR_MIN_CHARS = 8

    def _ocr_image_text(self, data: bytes) -> Optional[str]:
        """Recognized text when the ladder is available and confident, else None."""
        from ..ocr_glyph import get_default_ocr_fn

        try:
            ocr_fn = get_default_ocr_fn()
        except Exception:
            return None
        if ocr_fn is None:
            return None
        try:
            res = ocr_fn(data, "base")
        except Exception:
            return None
        text, conf = res if isinstance(res, tuple) else (res, 1.0)
        text = (text or "").strip()
        if conf < self._OCR_MIN_CONF or len(text) < self._OCR_MIN_CHARS:
            return None
        return text

    def _hash_image_vec(self, data: bytes) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(b"img\x00" + data).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    # fixed projection matrices cached per embedding dim (class-level: every
    # embedder instance of the same dim shares one visual subspace)
    _VISUAL_FEAT_DIM = 256 + 64 + 64 + 64  # lum grid + color hist + |dx| + |dy|
    _visual_proj_cache: dict = {}

    @classmethod
    def _visual_projection(cls, dim: int) -> np.ndarray:
        proj = cls._visual_proj_cache.get(dim)
        if proj is None:
            rng = np.random.default_rng(_seed_from("visual-feature-projection"))
            proj = rng.standard_normal((cls._VISUAL_FEAT_DIM, dim)).astype(np.float32)
            proj /= np.sqrt(cls._VISUAL_FEAT_DIM)
            cls._visual_proj_cache[dim] = proj
        return proj

    def _visual_image_vec(self, data: bytes) -> Optional[np.ndarray]:
        """Perceptual-feature embedding for images without recognizable text.

        The reference embeds ANY image through its vision model
        (core/embedder.py:141-210); hermetically we cover the image->image
        similarity half of that contract: a 16x16 contrast-normalized
        luminance grid, a 4x4x4 RGB histogram, and 8x8 horizontal/vertical
        gradient-energy grids (448 features) are projected to ``dim`` with a
        fixed seeded Gaussian matrix and L2-normalized. Deterministic; returns
        None when the payload cannot be decoded (caller falls back to hash)."""
        try:
            import io as _io

            from PIL import Image

            img = Image.open(_io.BytesIO(data)).convert("RGB")
            img = img.resize((32, 32), Image.BILINEAR)
            rgb = np.asarray(img, np.float32) / 255.0  # [32, 32, 3]
        except Exception:
            return None
        gray = rgb @ np.array([0.299, 0.587, 0.114], np.float32)  # [32, 32]
        # 16x16 luminance grid, brightness/contrast normalized
        g16 = gray.reshape(16, 2, 16, 2).mean(axis=(1, 3))
        g16 = g16 - g16.mean()
        g16 /= np.linalg.norm(g16) + 1e-6
        # 4x4x4 RGB histogram (L1) — color composition, layout-invariant
        q = np.minimum((rgb * 4.0).astype(np.int32), 3)
        bins = (q[..., 0] * 16 + q[..., 1] * 4 + q[..., 2]).ravel()
        hist = np.bincount(bins, minlength=64).astype(np.float32)
        hist /= hist.sum() + 1e-6
        # 8x8 gradient-energy grids — edge structure (diagram vs photo texture)
        dx = np.pad(np.abs(np.diff(gray, axis=1)), ((0, 0), (0, 1)))
        dy = np.pad(np.abs(np.diff(gray, axis=0)), ((0, 1), (0, 0)))
        ex = dx.reshape(8, 4, 8, 4).mean(axis=(1, 3)).ravel()
        ey = dy.reshape(8, 4, 8, 4).mean(axis=(1, 3)).ravel()
        for e in (ex, ey):
            e /= np.linalg.norm(e) + 1e-6
        feats = np.concatenate([g16.ravel(), 0.5 * hist, 0.5 * ex, 0.5 * ey])
        v = feats @ self._visual_projection(self.dim)
        n = float(np.linalg.norm(v))
        return v / n if n > 1e-9 else None

    # trained cross-modal aligner (models/visual_align.py): pixels -> text space,
    # the rung between OCR and perceptual features. Loaded once per width (and
    # device) from visual_align.DEFAULT_ALIGNER_PATH; absent weights disable the
    # rung. Only the trained EncoderEmbedder opts in (_aligner_compatible): the
    # aligner was trained against THAT text space. An unreadable or mismatched
    # weights file disables the rung too; any other error (torch, CUDA) raises.
    _aligner_cache: dict = {}
    _aligner_compatible = False

    def _aligned_image_vec(self, data: bytes) -> Optional[np.ndarray]:
        if not self._aligner_compatible:
            return None
        device = getattr(self, "device", None)
        key = (self.dim, str(device))
        if key not in self._aligner_cache:
            from .visual_align import VisualAlignEmbedder, load_aligner

            try:
                loaded = load_aligner()
            except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile, zlib.error):
                loaded = None
            self._aligner_cache[key] = (
                VisualAlignEmbedder(*loaded, out_dim=self.dim, device=device)
                if loaded is not None and loaded[1].out_dim >= self.dim
                else None
            )
        va = self._aligner_cache[key]
        return None if va is None else va.embed_image_bytes(data)

    def embed_images(self, images: Sequence[bytes]) -> np.ndarray:
        if not images:
            return np.zeros((0, self.dim), np.float32)
        out = np.zeros((len(images), self.dim), np.float32)
        texts: dict = {}  # index -> recognized text, embedded as one batch below
        for i, data in enumerate(images):
            text = self._ocr_image_text(data)
            if text is not None:
                texts[i] = text
            else:
                vis = self._aligned_image_vec(data)
                if vis is None:
                    vis = self._visual_image_vec(data)
                out[i] = vis if vis is not None else self._hash_image_vec(data)
        if texts:
            idx = list(texts)
            vecs = self.embed_texts([texts[i] for i in idx])
            for j, i in enumerate(idx):
                n = float(np.linalg.norm(vecs[j]))
                # zero text vector (embed_texts fail-soft) -> hash fallback
                out[i] = vecs[j] / n if n > 1e-9 else self._hash_image_vec(images[i])
        return out

    def embed_mixed(self, items: Sequence[tuple]) -> np.ndarray:
        """items: (modality, payload) pairs with modality 'text' | 'image'
        (lib parity: core/embedder.py:262 embed_mixed)."""
        out = np.zeros((len(items), self.dim), np.float32)
        for i, (modality, payload) in enumerate(items):
            if modality == "image":
                out[i] = self.embed_images([payload])[0]
            else:
                try:
                    out[i] = self.embed_query(str(payload))
                except ValueError:
                    pass  # untokenizable text -> zero vector (fail-soft)
        return out


class HashEmbedder(_ImageHashMixin):
    """Deterministic per-text Gaussian embedding."""

    def __init__(self, dim: int = 2048) -> None:
        self.dim = dim

    def _one(self, text: str) -> np.ndarray:
        g = np.random.default_rng(_seed_from(text))
        v = g.standard_normal(self.dim).astype(np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._one(t) for t in texts])

    def embed_query(self, text: str) -> np.ndarray:
        return self._one(text)


class BowHashEmbedder(_ImageHashMixin):
    """Bag-of-words hash embedding: each token hashes to a fixed Gaussian direction and
    a text embeds as the L2-normalized tf-weighted sum, so texts sharing vocabulary
    are cosine-similar without trained weights."""

    def __init__(self, dim: int = 2048, config: Optional[RAGConfig] = None) -> None:
        self.dim = dim
        self.config = config or get_settings()
        self._analyzer = Analyzer(self.config)
        self._token_cache: dict[str, np.ndarray] = {}
        self._mtok_cache: dict[tuple, np.ndarray] = {}  # (dim, token) -> unit vec
        self._tok_cache: dict[str, tuple] = {}  # short-text tokenization memo

    def _tok(self, text: str) -> tuple:
        if len(text) > 512:
            return tuple(self._analyzer.tokenize(text))
        toks = self._tok_cache.get(text)
        if toks is None:
            if len(self._tok_cache) > 8192:
                self._tok_cache.clear()
            toks = tuple(self._analyzer.tokenize(text))
            self._tok_cache[text] = toks
        return toks

    def _token_vec(self, token: str) -> np.ndarray:
        v = self._token_cache.get(token)
        if v is None:
            if len(self._token_cache) > 65536:
                self._token_cache.clear()
            g = np.random.default_rng(_seed_from("tok\x00" + token))
            v = g.standard_normal(self.dim).astype(np.float32)
            v /= np.linalg.norm(v)
            self._token_cache[token] = v
        return v

    def _one(self, text: str) -> np.ndarray:
        tokens = self._tok(text)
        if not tokens:
            return np.zeros(self.dim, np.float32)
        acc = np.zeros(self.dim, np.float32)
        for t in tokens:
            acc += self._token_vec(t)
        n = np.linalg.norm(acc)
        return acc / n if n > 0 else acc

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._one(t) for t in texts])

    def embed_query(self, text: str) -> np.ndarray:
        v = self._one(text)
        if not np.any(v):
            raise ValueError(f"query produced no tokens to embed: {text!r}")
        return v

    def mtok_vec(self, token: str, dim: int) -> np.ndarray:
        """Unit MaxSim token vector of one analyzer token."""
        key = (dim, token)
        v = self._mtok_cache.get(key)
        if v is None:
            if len(self._mtok_cache) > 65536:
                self._mtok_cache.clear()
            g = np.random.default_rng(_seed_from(f"mtok{dim}\x00" + token))
            v = g.standard_normal(dim).astype(np.float32)
            v /= np.linalg.norm(v)
            self._mtok_cache[key] = v
        return v

    def token_embeddings(
        self, texts: Sequence[str], max_tokens: Optional[int] = None, dim: Optional[int] = None
    ) -> np.ndarray:
        """f32[N, T, dim] per-token unit hash embeddings for MaxSim late interaction."""
        t = max_tokens or self.config.maxsim_doc_tokens
        d = dim or self.config.maxsim_dim
        out = np.zeros((len(texts), t, d), np.float32)
        for i, text in enumerate(texts):
            for j, tok in enumerate(self._tok(text)[:t]):
                out[i, j] = self.mtok_vec(tok, d)
        return out


def get_default_embedder(config: Optional[RAGConfig] = None, device=None):
    """Resolve ``config.embedder_backend`` to an embedder.

    "auto" prefers the packaged trained encoder, built on ``device`` (CUDA unless
    ``device="cpu"``), and falls back to :class:`BowHashEmbedder` only when the
    weights are absent or unreadable; "encoder" requires the weights and raises
    without them; "bowhash" and "hash" are the hash embedders."""
    cfg = config or get_settings()
    backend = cfg.embedder_backend
    if backend in ("auto", "encoder"):
        from .pretrain import load_default_encoder

        enc = load_default_encoder(cfg, device=device)
        if enc is not None:
            return enc
        if backend == "encoder":
            raise RuntimeError(
                "embedder_backend='encoder' but no packaged weights were found "
                "(triple_hybrid_rag_tpu/models/data/encoder.npz, or encoder_params_path)"
            )
    if backend == "hash":
        return HashEmbedder(dim=cfg.embedding_dim_full)
    return BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)


class FailSoftEmbedder:
    """Wrapper adding the reference's degradation ladder to any embedder: a failed
    bulk embed is retried item by item, and an item that still fails becomes a zero
    vector whose index is recorded in ``last_errors`` (reset by each bulk call).
    A caller that must not serve zero rows (a device failure would otherwise turn
    into them silently) checks ``last_errors`` after each call. Query embeds
    raise."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.dim = inner.dim
        self.last_errors: List[int] = []

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        self.last_errors = []
        try:
            return self.inner.embed_texts(texts)
        except Exception:
            out = np.zeros((len(texts), self.dim), np.float32)
            for i, t in enumerate(texts):
                try:
                    out[i] = self.inner.embed_query(t)
                except Exception:
                    self.last_errors.append(i)
            return out

    def embed_query(self, text: str) -> np.ndarray:
        return self.inner.embed_query(text)

    def __getattr__(self, name: str):
        # the inner embedder's other capabilities (token_embeddings,
        # maxsim_calibration, encode_queries_device, ...)
        return getattr(self.inner, name)
