"""Built-in glyph-template OCR: a hermetic recognizer for rendered text.

A copy of the JAX package's ``ocr_glyph.py``: the same atlas (rendered from PIL's
bundled font, so both packages agree on one machine), the same segmentation and
matching, hence the same text and confidence for the same image. The upstream
project recognizes text with a vision-LLM HTTP call and a pytesseract fallback; the
port has the same HTTP rung (``models/http_clients.HTTPVisionOCR``) and honors
pytesseract when its binary is installed. This module fills the bottom rung with a
working recognizer for MACHINE-RENDERED text (digital PDFs rasterized to images,
screenshots, generated reports):

1. grayscale + adaptive binarization,
2. text-line segmentation by horizontal ink projection,
3. glyph segmentation by vertical projection within each line (gap -> space),
4. per-glyph matching against an atlas rendered from PIL's bundled font via
   normalized template correlation; confidence = mean match score.

It is NOT a scanned-photo OCR (no deskew, no noise modeling — that is what the
vision-LLM rung is for); the honest confidence score lets ``OCRProcessor``'s mode
ladder escalate to a stronger backend when one is configured. Ladder selection lives
in :func:`get_default_ocr_fn`; the atlas is built once per process, on first use.
All of it runs on the host.
"""

from __future__ import annotations

import io
from typing import Callable, List, Optional, Tuple

import numpy as np

from .config import RAGConfig, get_settings

_CHARS = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
    ".,:;!?()[]%$#@&+-*/='\""
)
_FONT_SIZE = 18


def _load_font(size: int = _FONT_SIZE):
    from PIL import ImageFont

    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL: fixed-size bitmap font
        return ImageFont.load_default()


def render_text_image(
    text: str, width: int = 800, font_size: int = _FONT_SIZE, margin: int = 12
) -> bytes:
    """Render text to a PNG (the test-side generator for scanned-page fixtures)."""
    from PIL import Image, ImageDraw

    font = _load_font(font_size)
    lines = text.split("\n")
    line_h = int(font_size * 1.6)
    img = Image.new("L", (width, margin * 2 + line_h * len(lines)), 255)
    draw = ImageDraw.Draw(img)
    for i, line in enumerate(lines):
        draw.text((margin, margin + i * line_h), line, fill=0, font=font)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


class GlyphAtlas:
    """Per-character ink templates rendered from the bundled font."""

    def __init__(self, font_size: int = _FONT_SIZE) -> None:
        from PIL import Image, ImageDraw

        self.font_size = font_size
        font = _load_font(font_size)
        self.templates: List[Tuple[str, np.ndarray]] = []
        for ch in _CHARS:
            img = Image.new("L", (font_size * 3, font_size * 3), 255)
            ImageDraw.Draw(img).text((font_size, font_size // 2), ch, fill=0, font=font)
            arr = 255 - np.asarray(img, np.float32)  # ink = positive
            tpl = _crop_ink(arr)
            if tpl is not None:
                self.templates.append((ch, tpl / max(np.linalg.norm(tpl), 1e-6)))

    def match(self, glyph: np.ndarray) -> Tuple[str, float]:
        """Best (char, score in [0,1]) by normalized correlation at a common size."""
        g = glyph / max(np.linalg.norm(glyph), 1e-6)
        best_ch, best = "?", 0.0
        gh, gw = g.shape
        for ch, tpl in self.templates:
            th, tw = tpl.shape
            # quick aspect/shape gate before resampling
            if max(th, gh) > 2.2 * min(th, gh) or max(tw, gw) > 2.6 * min(tw, gw):
                continue
            t = _resample(tpl, g.shape)
            t = t / max(np.linalg.norm(t), 1e-6)
            score = float(np.sum(t * g))
            if score > best:
                best_ch, best = ch, score
        return best_ch, best


def _crop_ink(arr: np.ndarray, thresh: float = 32.0) -> Optional[np.ndarray]:
    ys, xs = np.where(arr > thresh)
    if ys.size == 0:
        return None
    return arr[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]


def _resample(arr: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize (dependency-free)."""
    h, w = shape
    ys = np.clip((np.arange(h) * arr.shape[0] / h).astype(int), 0, arr.shape[0] - 1)
    xs = np.clip((np.arange(w) * arr.shape[1] / w).astype(int), 0, arr.shape[1] - 1)
    return arr[ys][:, xs]


class GlyphOCR:
    """``ocr_fn(image_bytes, mode) -> (text, confidence)`` for OCRProcessor."""

    def __init__(self, font_size: int = _FONT_SIZE) -> None:
        self.atlas = GlyphAtlas(font_size)

    def __call__(self, image: bytes, mode: str = "base") -> Tuple[str, float]:
        from PIL import Image

        img = Image.open(io.BytesIO(image)).convert("L")
        arr = 255.0 - np.asarray(img, np.float32)  # ink positive
        arr[arr < 48] = 0.0  # binarize-ish
        lines: List[str] = []
        scores: List[float] = []
        for top, bot in _segments(arr.sum(axis=1) > 0):
            row = arr[top:bot]
            line_chars: List[str] = []
            col_ink = row.sum(axis=0) > 0
            spans = list(_segments(col_ink))
            if not spans:
                continue
            # space threshold: gaps wider than ~45% of median glyph width
            widths = [e - s for s, e in spans]
            med_w = float(np.median(widths))
            prev_end = None
            for s, e in spans:
                if prev_end is not None and (s - prev_end) > max(3, 0.45 * med_w):
                    line_chars.append(" ")
                chars, span_scores = self._recognize_span(row, s, e, med_w)
                line_chars.extend(chars)
                scores.extend(span_scores)
                prev_end = e
            lines.append("".join(line_chars))
        text = "\n".join(lines)
        conf = float(np.mean(scores)) if scores else 0.0
        return text, conf

    def _recognize_span(
        self, row: np.ndarray, s: int, e: int, med_w: float
    ) -> Tuple[List[str], List[float]]:
        """Recognize one ink span; kerned glyph pairs can touch (no blank column), so
        over-wide spans are HYPOTHESIS-scored: keep the whole-span match unless
        splitting at the internal ink minimum matches strictly better (this keeps a
        naturally wide 'm' whole while cutting a merged 'VO' apart)."""
        glyph = _crop_ink(row[:, s:e])
        if glyph is None:
            return [], []
        ch, score = self.atlas.match(glyph)
        w = e - s
        if w > max(5, 1.35 * med_w):
            profile = row[:, s:e].sum(axis=0)
            lo = max(2, int(0.3 * med_w))
            if w - 2 * lo >= 1:
                cut = s + lo + int(np.argmin(profile[lo : w - lo]))
                if s < cut < e - 1:
                    lc, ls = self._recognize_span(row, s, cut, med_w)
                    rc, rs = self._recognize_span(row, cut, e, med_w)
                    both = ls + rs
                    if both and float(np.mean(both)) > score + 0.02:
                        return lc + rc, both
        return [ch], [score]


def _segments(mask: np.ndarray):
    """Yield (start, end) runs of True in a 1-D boolean mask."""
    idx = np.where(mask)[0]
    if idx.size == 0:
        return
    start = prev = int(idx[0])
    for i in idx[1:]:
        i = int(i)
        if i != prev + 1:
            yield start, prev + 1
            start = i
        prev = i
    yield start, prev + 1


def get_default_ocr_fn(config: Optional[RAGConfig] = None) -> Optional[Callable]:
    """The recognizer ladder: HTTP vision LLM when configured -> pytesseract when
    installed (its binary probed) -> the built-in glyph matcher when PIL is
    available -> None (OCR disabled)."""
    cfg = config or get_settings()
    if cfg.ocr_api_base:
        from .models.http_clients import HTTPVisionOCR

        # memoize per config: embed_images resolves the ladder per image, and a
        # fresh HTTP client object per scanned page is pure ingestion overhead
        global _HTTP_OCR_SINGLETON
        if _HTTP_OCR_SINGLETON is None or _HTTP_OCR_SINGLETON[0] != cfg:
            _HTTP_OCR_SINGLETON = (
                cfg,
                HTTPVisionOCR(
                    cfg.ocr_api_base, model=cfg.ocr_api_model,
                    timeout_s=cfg.api_timeout_s, retries=cfg.api_retries,
                    api_key=cfg.api_key,
                ),
            )
        return _HTTP_OCR_SINGLETON[1]
    try:
        import pytesseract  # type: ignore

        from PIL import Image

        # probe the BINARY: a pip-installed pytesseract without the tesseract
        # executable imports fine but raises at call time — the OCR ladder then
        # swallowed every page as ('', 0.0) while the working glyph rung below
        # never got a chance
        pytesseract.get_tesseract_version()

        def tesseract_fn(image: bytes, mode: str = "base"):
            img = Image.open(io.BytesIO(image))
            return pytesseract.image_to_string(img)

        return tesseract_fn
    except Exception:
        pass
    try:
        import PIL  # noqa: F401

        global _GLYPH_SINGLETON
        if _GLYPH_SINGLETON is None:
            _GLYPH_SINGLETON = GlyphOCR()
        return _GLYPH_SINGLETON
    except ImportError:
        return None


_GLYPH_SINGLETON: Optional[GlyphOCR] = None
_HTTP_OCR_SINGLETON = None  # (config, HTTPVisionOCR) memo — one client per config
