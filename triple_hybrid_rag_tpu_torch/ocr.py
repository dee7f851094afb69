"""OCR with Gundam tiling: mode ladder, tile geometry, merge strategies.

A copy of the JAX package's ``ocr.py`` (the same tiles, merges and confidences).
The upstream project's OCR is a vision-LLM call over an OpenAI-compatible endpoint
with:

- a mode ladder tiny -> small -> base -> large -> gundam, escalating on low confidence
  with a retry limit,
- a text-quality confidence heuristic,
- **Gundam tiling** for large images: split >= ``trigger_px`` images into ``tile_px``
  tiles with ``overlap_px`` overlap, capped at ``max_tiles`` by rescaling the step,
  OCR the tiles, then merge with ``concat`` / ``fuzzy`` (dedup against the last N
  lines at >= 0.85 similarity) / ``vote`` strategies.

The character recognition itself is a pluggable host callable ``ocr_fn(image_bytes,
mode) -> text | (text, confidence)``: the HTTP vision client
(``models/http_clients.HTTPVisionOCR``), pytesseract, the built-in glyph matcher
(``ocr_glyph.py``) or a test stub. Everything around it (tiling math, escalation,
merging, confidence estimation) lives here, host-only.
"""

from __future__ import annotations

import difflib
import re
import struct
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from .types import OCRResult

OCR_MODES = ("tiny", "small", "base", "large", "gundam")


@dataclass(frozen=True)
class GundamTilingConfig:
    """Tiling parameters (reference ocr.py:41-62 defaults)."""

    trigger_px: int = 1500  # min(width, height) that triggers tiling
    tile_px: int = 1024
    overlap_px: int = 128
    max_tiles: int = 16
    merge_strategy: str = "fuzzy"  # concat | fuzzy | vote
    fuzzy_threshold: float = 0.85
    fuzzy_window: int = 10  # dedup against the last N merged lines


@dataclass
class OCRConfig:
    initial_mode: str = "base"
    confidence_threshold: float = 0.6
    retry_limit: int = 2
    tiling: GundamTilingConfig = field(default_factory=GundamTilingConfig)


# ---------------------------------------------------------------------------
# image geometry (pure math, no PIL needed for the common formats)
# ---------------------------------------------------------------------------


def image_size(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from PNG/JPEG/GIF magic structures; None if unknown."""
    if data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) >= 24:
        w, h = struct.unpack(">II", data[16:24])
        return int(w), int(h)
    if data[:3] == b"\xff\xd8\xff":
        i = 2
        while i + 9 < len(data):
            if data[i] != 0xFF:
                i += 1
                continue
            marker = data[i + 1]
            if marker == 0xFF:  # 0xFF fill bytes between markers are legal padding
                i += 1
                continue
            if marker in (0xC0, 0xC1, 0xC2, 0xC3):
                h, w = struct.unpack(">HH", data[i + 5 : i + 9])
                return int(w), int(h)
            if 0xD0 <= marker <= 0xD9:  # RSTn/SOI/EOI carry no length field
                i += 2
                continue
            seg_len = struct.unpack(">H", data[i + 2 : i + 4])[0]
            i += 2 + seg_len
        return None
    if data[:4] == b"GIF8" and len(data) >= 10:
        w, h = struct.unpack("<HH", data[6:10])
        return int(w), int(h)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP" and len(data) >= 30:
        # the loader accepts WEBP, so oversized WEBP scans must trigger tiling too
        fmt = data[12:16]
        if fmt == b"VP8X":
            w = 1 + int.from_bytes(data[24:27], "little")
            h = 1 + int.from_bytes(data[27:30], "little")
            return w, h
        if fmt == b"VP8L" and data[20] == 0x2F:
            bits = int.from_bytes(data[21:25], "little")
            return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        if fmt == b"VP8 ":
            w = int.from_bytes(data[26:28], "little") & 0x3FFF
            h = int.from_bytes(data[28:30], "little") & 0x3FFF
            return w, h
    return None


def should_use_gundam_tiling(width: int, height: int, cfg: GundamTilingConfig) -> bool:
    """Tile when either dimension reaches the trigger (reference ocr.py:455)."""
    return max(width, height) >= cfg.trigger_px


def calculate_tiles(
    width: int, height: int, cfg: GundamTilingConfig
) -> List[Tuple[int, int, int, int]]:
    """Tile boxes (x0, y0, x1, y1) with overlap; step rescales to honor max_tiles
    (reference ocr.py:474-531)."""
    tile = cfg.tile_px
    # a degenerate overlap >= tile would make the step 0/negative (range() crash)
    overlap = min(cfg.overlap_px, tile - 1)
    step = max(tile - overlap, 1)

    def axis_starts(extent: int, step_: int) -> List[int]:
        if extent <= tile:
            return [0]
        starts = list(range(0, extent - tile + 1, step_))
        if starts[-1] + tile < extent:
            starts.append(extent - tile)
        return starts

    xs, ys = axis_starts(width, step), axis_starts(height, step)
    # rescale the step until the tile count fits the cap; an oversized axis can
    # never go below 2 starts, so stop when the grid is irreducible (max_tiles < 4
    # previously looped until the step overflowed to float infinity)
    while len(xs) * len(ys) > cfg.max_tiles and (len(xs) > 2 or len(ys) > 2):
        step = int(step * 1.5) + 1
        xs, ys = axis_starts(width, step), axis_starts(height, step)
    return [
        (x, y, min(x + tile, width), min(y + tile, height)) for y in ys for x in xs
    ]


# ---------------------------------------------------------------------------
# confidence heuristic (reference ocr.py:387 text-quality estimate)
# ---------------------------------------------------------------------------

# unicode word chars (letters in ANY script + digits): a Latin-only class capped
# flawless CJK/Cyrillic/Arabic or numeric OCR output at 0.6, escalating every
# non-Latin page through the whole mode ladder
_WORD_RE = re.compile(r"[^\W_]{2,}", re.UNICODE)


def estimate_confidence(text: str) -> float:
    """Text-quality score in [0, 1]: word density, printable ratio, repetition."""
    if not text or not text.strip():
        return 0.0
    printable = sum(1 for c in text if c.isprintable() or c in "\n\t")
    printable_ratio = printable / len(text)
    words = _WORD_RE.findall(text)
    tokens = text.split()
    word_ratio = len(words) / max(len(tokens), 1)
    # heavy single-character repetition is garbage OCR
    if len(text) >= 20:
        most_common = max(text.count(c) for c in set(text) if not c.isspace()) if text.strip() else 0
        repetition_penalty = min(1.0, 3.0 * (1.0 - most_common / max(len(text), 1)))
    else:
        repetition_penalty = 1.0
    score = 0.4 * printable_ratio + 0.4 * min(word_ratio, 1.0) + 0.2 * repetition_penalty
    return max(0.0, min(1.0, score))


def next_mode(mode: str) -> Optional[str]:
    """Escalation ladder (reference ocr.py:441-449): one step up, gundam is terminal."""
    i = OCR_MODES.index(mode)
    return OCR_MODES[i + 1] if i + 1 < len(OCR_MODES) else None


# ---------------------------------------------------------------------------
# merge strategies (reference ocr.py:597-702)
# ---------------------------------------------------------------------------


def merge_concat(tile_texts: Sequence[str]) -> str:
    return "\n".join(t.strip() for t in tile_texts if t.strip())


def merge_fuzzy(tile_texts: Sequence[str], cfg: GundamTilingConfig) -> str:
    """Line-level dedup: drop lines >= threshold-similar to any of the last N merged
    lines (overlap regions produce near-duplicate lines at tile seams)."""
    merged: List[str] = []
    for text in tile_texts:
        for line in text.splitlines():
            line = line.rstrip()
            if not line.strip():
                continue
            window = merged[-cfg.fuzzy_window :]
            dup = any(
                difflib.SequenceMatcher(None, line, prev).ratio() >= cfg.fuzzy_threshold
                for prev in window
            )
            if not dup:
                merged.append(line)
    return "\n".join(merged)


def merge_vote(
    tile_results: Sequence[Tuple[str, float]], cfg: GundamTilingConfig
) -> str:
    """Confidence-weighted voting: for near-duplicate lines keep the highest-confidence
    variant (reference ocr.py:662-702)."""
    kept: List[Tuple[str, float]] = []
    for text, conf in tile_results:
        for line in text.splitlines():
            line = line.rstrip()
            if not line.strip():
                continue
            matched = False
            for i, (prev, prev_conf) in enumerate(kept[-cfg.fuzzy_window :]):
                idx = len(kept) - min(len(kept), cfg.fuzzy_window) + i
                if difflib.SequenceMatcher(None, line, prev).ratio() >= cfg.fuzzy_threshold:
                    if conf > prev_conf:
                        kept[idx] = (line, conf)
                    matched = True
                    break
            if not matched:
                kept.append((line, conf))
    return "\n".join(line for line, _ in kept)


# ---------------------------------------------------------------------------
# processor
# ---------------------------------------------------------------------------


class OCRProcessor:
    """Mode-ladder OCR with Gundam tiling over a pluggable recognition callable."""

    def __init__(
        self,
        ocr_fn: Callable[..., object],  # (image_bytes, mode) -> str | (str, conf)
        config: Optional[OCRConfig] = None,
        crop_fn: Optional[Callable[[bytes, Tuple[int, int, int, int]], bytes]] = None,
    ) -> None:
        self.ocr_fn = ocr_fn
        self.config = config or OCRConfig()
        self._crop_fn = crop_fn

    # -- recognition wrapper --

    def _call_ocr(self, image: bytes, mode: str) -> Tuple[str, float]:
        out = self.ocr_fn(image, mode)
        if isinstance(out, tuple):
            text, conf = out
            return str(text), float(conf)
        text = str(out)
        return text, estimate_confidence(text)

    def _crop(self, image: bytes, box: Tuple[int, int, int, int]) -> bytes:
        if self._crop_fn is not None:
            return self._crop_fn(image, box)
        try:
            import io

            from PIL import Image

            img = Image.open(io.BytesIO(image))
            buf = io.BytesIO()
            img.crop(box).save(buf, format="PNG")
            return buf.getvalue()
        except ImportError as e:  # no PIL: caller must supply crop_fn for tiling
            raise RuntimeError("gundam tiling needs PIL or an explicit crop_fn") from e

    # -- public --

    def process_image(self, image: bytes, mode: Optional[str] = None) -> OCRResult:
        """Mode ladder with confidence-threshold escalation (reference ocr.py:133-220)."""
        cfg = self.config
        mode = mode or cfg.initial_mode
        size = image_size(image)

        if (
            size is not None
            and should_use_gundam_tiling(*size, cfg.tiling)
        ):
            return self._process_gundam(image, size)

        attempts = 0
        best: Tuple[str, float, str] = ("", 0.0, mode)
        current: Optional[str] = mode
        while current is not None and attempts <= cfg.retry_limit:
            try:
                text, conf = self._call_ocr(image, current)
            except Exception:
                text, conf = "", 0.0
            if conf > best[1]:
                best = (text, conf, current)
            if conf >= cfg.confidence_threshold:
                return OCRResult(text=text, confidence=conf, mode=current, tiles_used=1)
            current = next_mode(current)
            attempts += 1
        text, conf, used = best
        return OCRResult(text=text, confidence=conf, mode=used, tiles_used=1,
                         metadata={"escalated": True})

    def _process_gundam(self, image: bytes, size: Tuple[int, int]) -> OCRResult:
        cfg = self.config.tiling
        boxes = calculate_tiles(*size, cfg)
        results: List[Tuple[str, float]] = []
        for box in boxes:
            tile = self._crop(image, box)
            try:
                results.append(self._call_ocr(tile, "gundam"))
            except Exception:
                results.append(("", 0.0))
        if cfg.merge_strategy == "concat":
            text = merge_concat([t for t, _ in results])
        elif cfg.merge_strategy == "vote":
            text = merge_vote(results, cfg)
        else:
            text = merge_fuzzy([t for t, _ in results], cfg)
        confs = [c for _, c in results if c > 0]
        conf = sum(confs) / len(confs) if confs else 0.0
        return OCRResult(
            text=text, confidence=conf, mode="gundam", tiles_used=len(boxes),
            metadata={"tile_boxes": boxes, "merge": cfg.merge_strategy},
        )
