"""Document loader: file -> pages of text (host-side ingestion stage).

A copy of the JAX package's ``loader.py`` for the text family: file-type detection
by extension and magic bytes, and the text, Markdown, HTML (headings and tables
kept as markdown), CSV (a markdown table, paginated by rows) and JSON (flattened
key paths) loaders, with the same pages. PDF, office and image files need the
PDF and office text extractors and OCR, which are not ported yet (ROADMAP.md,
Queue 1 item 5): their loaders raise ``NotImplementedError``.
"""

from __future__ import annotations

import csv
import io
import json
import re
from pathlib import Path
from typing import List, Optional

from .types import FileType, LoadedDocument, Modality, PageContent

_EXT_MAP = {
    ".pdf": FileType.PDF,
    ".docx": FileType.DOCX,
    ".txt": FileType.TXT,
    ".text": FileType.TXT,
    ".md": FileType.MD,
    ".markdown": FileType.MD,
    ".csv": FileType.CSV,
    ".tsv": FileType.CSV,
    ".xlsx": FileType.XLSX,
    ".json": FileType.JSON,
    ".html": FileType.HTML,
    ".htm": FileType.HTML,
    ".png": FileType.IMAGE,
    ".jpg": FileType.IMAGE,
    ".jpeg": FileType.IMAGE,
    ".webp": FileType.IMAGE,
    ".gif": FileType.IMAGE,
}

_MAGIC = [
    (b"%PDF-", FileType.PDF),
    (b"\x89PNG\r\n\x1a\n", FileType.IMAGE),
    (b"\xff\xd8\xff", FileType.IMAGE),
    (b"GIF8", FileType.IMAGE),
    (b"PK\x03\x04", FileType.DOCX),  # zip container (docx/xlsx disambiguated by ext)
]

_TAG_RE = re.compile(r"<[^>]+>")
_SCRIPT_RE = re.compile(r"<(script|style)\b.*?</\1>", re.DOTALL | re.IGNORECASE)
PAGE_CHAR_BUDGET = 4000  # synthesize page boundaries for unpaged text formats


class UnsupportedFormatError(RuntimeError):
    pass


def detect_file_type(path: str | Path, data: Optional[bytes] = None) -> FileType:
    """Extension first, magic bytes as tiebreak/fallback (reference loader.py:119).

    RIFF is a generic container: it maps to IMAGE only when bytes 8-12 say WEBP
    (a WAV/AVI — or a text file starting with the word 'RIFF' — must not be
    routed into OCR), and magic never overrides a known TEXT extension."""
    ext_type = _EXT_MAP.get(Path(path).suffix.lower(), FileType.UNKNOWN)
    if data and ext_type not in (FileType.TXT, FileType.MD, FileType.CSV, FileType.HTML):
        if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
            return FileType.IMAGE
        for magic, ftype in _MAGIC:
            if data.startswith(magic):
                if ftype == FileType.DOCX and ext_type in (FileType.XLSX, FileType.DOCX):
                    return ext_type
                if ext_type == FileType.UNKNOWN or ftype != FileType.DOCX:
                    return ftype
    return ext_type


class DocumentLoader:
    """file path/bytes -> LoadedDocument (pages of text + modality)."""

    def load(self, path: str | Path, data: Optional[bytes] = None) -> LoadedDocument:
        path = Path(path)
        if data is None:
            data = path.read_bytes()
        ftype = detect_file_type(path, data)

        if ftype in (FileType.TXT, FileType.MD, FileType.UNKNOWN):
            return self._load_text(path, data, ftype)
        if ftype == FileType.HTML:
            return self._load_html(path, data)
        if ftype == FileType.CSV:
            return self._load_csv(path, data)
        if ftype == FileType.JSON:
            return self._load_json(path, data)
        if ftype == FileType.PDF:
            return self._load_pdf(path, data)
        if ftype == FileType.IMAGE:
            return self._load_image(path, data)
        if ftype in (FileType.DOCX, FileType.XLSX):
            return self._load_office(path, data, ftype)
        raise UnsupportedFormatError(f"unsupported file type {ftype} for {path.name}")

    # ------------------------------------------------------------------

    @staticmethod
    def _paginate(text: str) -> List[str]:
        """Split long unpaged text into page-budget chunks at paragraph boundaries."""
        if len(text) <= PAGE_CHAR_BUDGET:
            return [text] if text.strip() else []
        pages, buf, size = [], [], 0
        for para in text.split("\n\n"):
            if size + len(para) > PAGE_CHAR_BUDGET and buf:
                pages.append("\n\n".join(buf))
                buf, size = [], 0
            buf.append(para)
            size += len(para) + 2
        if buf:
            pages.append("\n\n".join(buf))
        return pages

    def _load_text(self, path: Path, data: bytes, ftype: FileType) -> LoadedDocument:
        text = data.decode("utf-8", errors="replace")
        if ftype == FileType.UNKNOWN and text:
            # binary sniff: refuse to ingest non-text bytes as garbage "documents"
            sample = text[:4096]
            bad = sum(1 for c in sample if c == "�" or (ord(c) < 32 and c not in "\n\r\t"))
            if bad / max(len(sample), 1) > 0.05:
                raise UnsupportedFormatError(
                    f"{path.name} looks binary (unknown format); refusing to ingest as text"
                )
        pages = [
            PageContent(page_number=i + 1, text=t)
            for i, t in enumerate(self._paginate(text))
        ]
        return LoadedDocument(filename=path.name, file_type=ftype, pages=pages)

    def _load_html(self, path: Path, data: bytes) -> LoadedDocument:
        raw = data.decode("utf-8", errors="replace")
        raw = _SCRIPT_RE.sub(" ", raw)
        # h1-h6 -> markdown headings so the chunker keeps structure
        raw = re.sub(
            r"<h([1-6])[^>]*>(.*?)</h\1>",
            lambda m: "\n" + "#" * int(m.group(1)) + " " + _TAG_RE.sub("", m.group(2)) + "\n",
            raw,
            flags=re.DOTALL | re.IGNORECASE,
        )

        # <table> -> markdown so the chunker keeps tables atomic (reference semantics)
        def table_md(m: re.Match) -> str:
            rows = []
            for tr in re.finditer(r"<tr[^>]*>(.*?)</tr>", m.group(0), re.DOTALL | re.IGNORECASE):
                cells = [
                    re.sub(r"\s+", " ", _TAG_RE.sub("", c)).strip()
                    for c in re.findall(
                        r"<t[hd][^>]*>(.*?)</t[hd]>", tr.group(1), re.DOTALL | re.IGNORECASE
                    )
                ]
                if cells:
                    rows.append(cells)
            if not rows:
                return " "
            width = max(len(r) for r in rows)
            rows = [r + [""] * (width - len(r)) for r in rows]
            md = ["| " + " | ".join(rows[0]) + " |", "|" + "---|" * width]
            md += ["| " + " | ".join(r) + " |" for r in rows[1:]]
            return "\n" + "\n".join(md) + "\n"

        raw = re.sub(r"<table[^>]*>.*?</table>", table_md, raw, flags=re.DOTALL | re.IGNORECASE)
        raw = re.sub(r"<(p|div|br|li|tr)[^>]*>", "\n", raw, flags=re.IGNORECASE)
        text = _TAG_RE.sub(" ", raw)
        text = re.sub(r"[ \t]+", " ", text)
        text = re.sub(r"\n\s*\n+", "\n\n", text).strip()
        pages = [PageContent(page_number=i + 1, text=t) for i, t in enumerate(self._paginate(text))]
        return LoadedDocument(filename=path.name, file_type=FileType.HTML, pages=pages)

    def _load_csv(self, path: Path, data: bytes) -> LoadedDocument:
        """CSV -> markdown table (reference loader.py:396 semantics: tables stay tables)."""
        text = data.decode("utf-8", errors="replace")
        delim = "\t" if path.suffix.lower() == ".tsv" else ","
        rows = list(csv.reader(io.StringIO(text), delimiter=delim))
        if not rows:
            return LoadedDocument(filename=path.name, file_type=FileType.CSV, pages=[])
        md_lines = ["| " + " | ".join(rows[0]) + " |",
                    "|" + "---|" * len(rows[0])]
        md_lines += ["| " + " | ".join(r) + " |" for r in rows[1:]]
        # paginate by row budget so giant CSVs do not become one mega-page
        header = md_lines[:2]
        body = md_lines[2:]
        per_page = max(1, PAGE_CHAR_BUDGET // max(len(md_lines[0]), 20))
        pages = []
        for i in range(0, max(len(body), 1), per_page):
            chunk = "\n".join(header + body[i : i + per_page])
            pages.append(
                PageContent(page_number=len(pages) + 1, text=chunk, modality=Modality.TABLE)
            )
        return LoadedDocument(filename=path.name, file_type=FileType.CSV, pages=pages)

    def _load_json(self, path: Path, data: bytes) -> LoadedDocument:
        try:
            obj = json.loads(data.decode("utf-8", errors="replace"))
        except json.JSONDecodeError as e:
            raise UnsupportedFormatError(f"invalid JSON in {path.name}: {e}") from e

        lines: List[str] = []

        def walk(o, prefix=""):
            if isinstance(o, dict):
                for k, v in o.items():
                    walk(v, f"{prefix}{k}.")
            elif isinstance(o, list):
                for i, v in enumerate(o):
                    walk(v, f"{prefix}{i}.")
            else:
                lines.append(f"{prefix.rstrip('.')}: {o}")

        walk(obj)
        text = "\n".join(lines)
        pages = [PageContent(page_number=i + 1, text=t) for i, t in enumerate(self._paginate(text))]
        return LoadedDocument(filename=path.name, file_type=FileType.JSON, pages=pages)

    def _load_pdf(self, path: Path, data: bytes) -> LoadedDocument:
        raise NotImplementedError(
            f"{path.name}: PDF text extraction (pdf_text.py) and OCR are not ported yet "
            "(ROADMAP.md, Queue 1 item 5)"
        )

    def _load_image(self, path: Path, data: bytes) -> LoadedDocument:
        raise NotImplementedError(
            f"{path.name}: images need OCR (ocr.py, ocr_glyph.py), which is not ported yet "
            "(ROADMAP.md, Queue 1 item 5)"
        )

    def _load_office(self, path: Path, data: bytes, ftype: FileType) -> LoadedDocument:
        raise NotImplementedError(
            f"{path.name}: DOCX/XLSX extraction (office_text.py) is not ported yet "
            "(ROADMAP.md, Queue 1 item 5)"
        )
