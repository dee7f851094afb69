"""Minimal dependency-free PDF text extraction (stdlib only).

A copy of the JAX package's ``pdf_text.py`` (the same pages and text for the same
bytes). The upstream project reads PDFs with PyMuPDF and a pypdf fallback; this
module implements the common-case subset so PDF ingestion works without either:
digitally-generated PDFs with Flate-compressed (or raw) content streams and standard
text operators. It is NOT a full PDF renderer: scanned pages, exotic encodings,
CID-keyed fonts without ToUnicode, and encrypted files fall back to the OCR path
(:func:`extract_pdf_images`) or a clear UnsupportedFormatError upstream.

Supported:
- object/stream scanning without a full xref parse (robust to mild damage),
- FlateDecode (zlib) and uncompressed streams,
- text extraction from BT/ET blocks: Tj, ', ", TJ (with kerning-aware spacing),
- literal strings (escapes, octal) and hex strings; UTF-16BE with BOM,
- line breaks from Td/TD/T*/TL heuristics; page splitting via /Type /Page count order.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import List, Optional

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.DOTALL)
_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj(.*?)endobj", re.DOTALL)
# BT/ET must be standalone operators: raw substrings match the ET inside
# uppercase text like (MARKET) and truncate the block, dropping the page
_TEXT_BLOCK_RE = re.compile(
    rb"(?:^|[\s>\]])BT(?P<body>.*?)(?:^|[\s)\]>])ET(?=[\s/\[<(]|$)", re.DOTALL
)

# text-showing and positioning operators inside a BT/ET block
_OP_RE = re.compile(
    rb"""
    (?P<str>\((?:\\.|[^()\\]|\((?:\\.|[^()\\])*\))*\))\s*(?P<sop>Tj|'|")
  | (?P<hex><[0-9A-Fa-f\s]*>)\s*(?P<hop>Tj|'|")
  | (?P<arr>\[(?:[^\[\]\\]|\\.)*?\])\s*TJ
  | (?P<move>-?[\d.]+\s+-?[\d.]+\s+(?:Td|TD))
  | (?P<tstar>T\*)
    """,
    re.VERBOSE | re.DOTALL,
)
_ARR_ITEM_RE = re.compile(
    rb"(\((?:\\.|[^()\\])*\))|(<[0-9A-Fa-f\s]*>)|(-?[\d.]+)"
)

_ESCAPES = {
    b"n": "\n", b"r": "\r", b"t": "\t", b"b": "\b", b"f": "\f",
    b"(": "(", b")": ")", b"\\": "\\",
}


def _decode_literal(raw: bytes) -> str:
    """PDF literal string (between parens) -> text."""
    body = raw[1:-1]
    if body.startswith(b"\xfe\xff"):
        try:
            return body.decode("utf-16-be", errors="replace")[1:]
        except Exception:
            pass
    out: List[str] = []
    i = 0
    while i < len(body):
        c = body[i : i + 1]
        if c == b"\\" and i + 1 < len(body):
            nxt = body[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt.isdigit():  # octal escape, up to 3 digits
                j = i + 1
                while j < len(body) and j < i + 4 and body[j : j + 1].isdigit():
                    j += 1
                try:
                    out.append(chr(int(body[i + 1 : j], 8)))
                except ValueError:
                    pass
                i = j
                continue
            i += 2  # escaped newline or unknown: skip
            continue
        out.append(c.decode("latin-1"))
        i += 1
    return "".join(out)


def _decode_hex(raw: bytes) -> str:
    hexstr = re.sub(rb"\s", b"", raw[1:-1])
    if len(hexstr) % 2:
        hexstr += b"0"
    data = bytes.fromhex(hexstr.decode("ascii"))
    if data.startswith(b"\xfe\xff"):
        return data.decode("utf-16-be", errors="replace")[1:]
    # without font cmaps, treat as latin-1 (single-byte) or utf-16 (double-byte heuristic)
    if len(data) >= 4 and data[0] == 0 and data[2] == 0:
        return data.decode("utf-16-be", errors="replace")
    return data.decode("latin-1", errors="replace")


def _extract_block_text(block: bytes) -> str:
    parts: List[str] = []
    for m in _OP_RE.finditer(block):
        if m.group("str") is not None:
            if m.group("sop") in (b"'", b'"'):
                parts.append("\n")
            parts.append(_decode_literal(m.group("str")))
        elif m.group("hex") is not None:
            if m.group("hop") in (b"'", b'"'):
                parts.append("\n")
            parts.append(_decode_hex(m.group("hex")))
        elif m.group("arr") is not None:
            for item in _ARR_ITEM_RE.finditer(m.group("arr")):
                if item.group(1):
                    parts.append(_decode_literal(item.group(1)))
                elif item.group(2):
                    parts.append(_decode_hex(item.group(2)))
                else:
                    # large negative kerning = inter-word gap
                    try:
                        if float(item.group(3)) < -150:
                            parts.append(" ")
                    except ValueError:
                        pass
        elif m.group("move") is not None:
            # dy == 0 is a horizontal word-positioning move, not a line break
            try:
                dy = float(m.group("move").split()[1])
            except (ValueError, IndexError):
                dy = 1.0
            parts.append(" " if dy == 0 else "\n")
        elif m.group("tstar") is not None:
            parts.append("\n")
    return "".join(parts)


def extract_pdf_text(data: bytes) -> List[str]:
    """PDF bytes -> per-page-ish text blocks (one string per content stream that
    contained text). Returns [] when nothing extractable (e.g. scanned/encrypted)."""
    if b"/Encrypt" in data[:4096] or b"/Encrypt" in data[-4096:]:
        return []
    pages: List[str] = []
    for m in _STREAM_RE.finditer(data):
        raw = m.group(1)
        candidates = [raw]
        try:
            candidates.insert(0, zlib.decompress(raw))
        except zlib.error:
            # some writers pad the stream; retry trimmed
            try:
                candidates.insert(0, zlib.decompress(raw.strip(b"\r\n")))
            except zlib.error:
                pass
        for content in candidates:
            if b"BT" not in content:
                continue
            text_parts = [
                _extract_block_text(b.group("body")) for b in _TEXT_BLOCK_RE.finditer(content)
            ]
            text = "\n".join(p for p in text_parts if p.strip())
            # collapse PDF-operator artifacts
            text = re.sub(r"[ \t]+", " ", text)
            text = re.sub(r"\n{3,}", "\n\n", text).strip()
            if text:
                pages.append(text)
            break
    return pages


# ---------------------------------------------------------------------------
# image-only pages (a port addition: the JAX package raises for these without
# PyMuPDF)
# ---------------------------------------------------------------------------

_DICT_INT = rb"/%s\s+(\d+)"


def _dict_int(head: bytes, key: bytes) -> Optional[int]:
    m = re.search(_DICT_INT % key, head)
    return int(m.group(1)) if m else None


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + kind + body
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    )


def extract_pdf_images(data: bytes) -> List[bytes]:
    """PDF bytes -> the image XObjects as image files, in file order: DCTDecode
    streams as the JPEGs they are, 8-bit DeviceGray/DeviceRGB FlateDecode (or raw)
    pixels rebuilt into PNGs (a PNG-predictor stream is a PNG's own IDAT data).
    What a scanned page holds; other image encodings are skipped."""
    if b"/Encrypt" in data[:4096] or b"/Encrypt" in data[-4096:]:
        return []
    out: List[bytes] = []
    for m in _OBJ_RE.finditer(data):
        body = m.group(3)
        at = body.find(b"stream")
        if at < 0:
            continue
        head = body[:at]
        if not re.search(rb"/Subtype\s*/Image", head):
            continue
        raw = body[at + len(b"stream"):]
        raw = raw[2:] if raw.startswith(b"\r\n") else raw[1:]
        length = _dict_int(head, b"Length")
        raw = raw[:length] if length is not None and length <= len(raw) else raw.rsplit(
            b"endstream", 1)[0].rstrip(b"\r\n")
        if b"/DCTDecode" in head:
            out.append(raw)
            continue
        w, h = _dict_int(head, b"Width"), _dict_int(head, b"Height")
        colors = 3 if b"/DeviceRGB" in head else 1 if b"/DeviceGray" in head else 0
        if not w or not h or not colors or _dict_int(head, b"BitsPerComponent") != 8:
            continue
        predictor = _dict_int(head, b"Predictor") or 1
        flate = b"/FlateDecode" in head
        if flate and predictor >= 10:
            idat = raw  # rows already carry PNG filter bytes
        else:
            try:
                pixels = zlib.decompress(raw) if flate else raw
            except zlib.error:
                continue
            stride = w * colors
            if len(pixels) < stride * h:
                continue
            idat = zlib.compress(b"".join(
                b"\x00" + pixels[y * stride:(y + 1) * stride] for y in range(h)
            ))
        ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if colors == 3 else 0, 0, 0, 0)
        out.append(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                   + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))
    return out
