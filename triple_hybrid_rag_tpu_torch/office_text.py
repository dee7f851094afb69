"""Minimal dependency-free DOCX/XLSX text extraction (stdlib zipfile + regex).

A copy of the JAX package's ``office_text.py`` (the same text for the same bytes).
The upstream project loads DOCX with python-docx (headings and tables) and XLSX with
openpyxl (markdown tables); OOXML is a zip of XML parts, so the common-case subset
extracts without either:

- DOCX: paragraphs from ``word/document.xml`` with heading styles mapped to markdown
  ``#`` levels; table cells joined into markdown rows.
- XLSX: shared strings + sheet cell values -> one markdown table per sheet
  (inline strings and numeric cells supported; formulas yield their cached values).
"""

from __future__ import annotations

import io
import re
import zipfile
from typing import Dict, List

_W_P = re.compile(rb"<w:p[ >].*?</w:p>", re.DOTALL)
_W_STYLE = re.compile(rb'<w:pStyle w:val="([^"]+)"')
_W_TEXT = re.compile(rb"<w:t(?: [^>]*)?>(.*?)</w:t>", re.DOTALL)
_W_TBL = re.compile(rb"<w:tbl>.*?</w:tbl>", re.DOTALL)
_W_TR = re.compile(rb"<w:tr[ >].*?</w:tr>", re.DOTALL)
_W_TC = re.compile(rb"<w:tc>.*?</w:tc>", re.DOTALL)
_HEADING_LEVEL = re.compile(rb"[Hh]eading(\d)")

_XL_SHARED = re.compile(rb"<si>(.*?)</si>", re.DOTALL)
_XL_T = re.compile(rb"<t(?: [^>]*)?>(.*?)</t>", re.DOTALL)
_XL_ROW = re.compile(rb"<row[ >].*?</row>", re.DOTALL)
_XL_CELL = re.compile(rb'<c(?: [^>]*?)?(?: t="([^"]*)")?(?: [^>]*)?>(.*?)</c>', re.DOTALL)
_XL_V = re.compile(rb"<v>(.*?)</v>", re.DOTALL)
_XL_REF = re.compile(rb'r="([A-Z]+)\d+"')

_ENTITIES = {"&amp;": "&", "&lt;": "<", "&gt;": ">", "&quot;": '"', "&apos;": "'"}


def _unescape(raw: bytes) -> str:
    text = raw.decode("utf-8", errors="replace")
    text = re.sub(r"<[^>]+>", "", text)  # strip nested tags (e.g. w:tab)
    # ONE pass so '&amp;lt;' -> '&lt;' (replacing '&amp;' first then '&lt;'
    # double-unescaped literal entity text)
    return re.sub(
        r"&(amp|lt|gt|quot|apos);",
        lambda m: {"amp": "&", "lt": "<", "gt": ">", "quot": '"', "apos": "'"}[m.group(1)],
        text,
    )


def extract_docx_text(data: bytes) -> str:
    """DOCX bytes -> markdown-ish text (headings + paragraphs + tables)."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        xml = zf.read("word/document.xml")

    # tables first: replace them with placeholders so paragraphs inside are not doubled
    tables: List[str] = []

    def table_md(m: re.Match) -> bytes:
        rows = []
        for tr in _W_TR.finditer(m.group(0)):
            cells = [
                # runs join with '' (Word splits single words across w:t runs);
                # paragraphs inside one cell would need w:p handling, which the
                # space-join wrongly simulated at the cost of splitting words
                "".join(_unescape(t) for t in _W_TEXT.findall(tc.group(0))).strip()
                for tc in _W_TC.finditer(tr.group(0))
            ]
            rows.append(cells)
        if not rows:
            return b""
        md = ["| " + " | ".join(rows[0]) + " |", "|" + "---|" * len(rows[0])]
        md += ["| " + " | ".join(r) + " |" for r in rows[1:]]
        tables.append("\n".join(md))
        return b"\x00TBL%d\x00" % (len(tables) - 1)

    xml = _W_TBL.sub(table_md, xml)

    # walk body segments BETWEEN table placeholders so tables keep their
    # document position (they are body-level siblings of w:p, so a placeholder
    # can never appear inside a paragraph match — appending them all at the end
    # detached mid-document tables from their sections)
    parts: List[str] = []

    def emit_paragraphs(segment: bytes) -> None:
        for p in _W_P.finditer(segment):
            block = p.group(0)
            text = "".join(_unescape(t) for t in _W_TEXT.findall(block)).strip()
            if not text:
                continue
            style = _W_STYLE.search(block)
            if style:
                lvl = _HEADING_LEVEL.search(style.group(1))
                if lvl:
                    text = "#" * int(lvl.group(1)) + " " + text
            parts.append(text)

    pos = 0
    for ph in re.finditer(rb"\x00TBL(\d+)\x00", xml):
        emit_paragraphs(xml[pos : ph.start()])
        idx = int(ph.group(1))
        if 0 <= idx < len(tables):
            parts.append(tables[idx])
        pos = ph.end()
    emit_paragraphs(xml[pos:])
    return "\n\n".join(parts).strip()


def extract_xlsx_tables(data: bytes) -> List[str]:
    """XLSX bytes -> one markdown table per worksheet."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            for si in _XL_SHARED.finditer(zf.read("xl/sharedStrings.xml")):
                shared.append("".join(_unescape(t) for t in _XL_T.findall(si.group(0))))
        def _sheet_no(name: str) -> int:
            m = re.search(r"sheet(\d+)\.xml$", name)
            return int(m.group(1)) if m else 0

        # numeric order: lexicographic put sheet10 before sheet2
        sheets = sorted(
            (
                n for n in zf.namelist()
                if n.startswith("xl/worksheets/sheet") and n.endswith(".xml")
            ),
            key=_sheet_no,
        )
        out: List[str] = []
        for name in sheets:
            xml = zf.read(name)
            rows: List[List[str]] = []
            for row in _XL_ROW.finditer(xml):
                cells: List[str] = []
                for c in _XL_CELL.finditer(row.group(0)):
                    # place by the r="C1" reference: Excel OMITS blank cells
                    # from the XML, and positional append shifted later values
                    # into the wrong columns
                    ref = _XL_REF.search(c.group(0))
                    if ref is not None:
                        col = 0
                        for ch in ref.group(1).decode():
                            col = col * 26 + (ord(ch) - 64)
                        while len(cells) < col - 1:
                            cells.append("")
                    ctype, body = c.group(1), c.group(2)
                    v = _XL_V.search(body)
                    if ctype == b"s" and v is not None:
                        idx = int(_unescape(v.group(1)) or 0)
                        cells.append(shared[idx] if idx < len(shared) else "")
                    elif ctype == b"inlineStr":
                        cells.append("".join(_unescape(t) for t in _XL_T.findall(body)))
                    elif v is not None:
                        cells.append(_unescape(v.group(1)))
                    else:
                        cells.append("")
                if any(c.strip() for c in cells):
                    rows.append(cells)
            if not rows:
                continue
            width = max(len(r) for r in rows)
            rows = [r + [""] * (width - len(r)) for r in rows]
            md = ["| " + " | ".join(rows[0]) + " |", "|" + "---|" * width]
            md += ["| " + " | ".join(r) + " |" for r in rows[1:]]
            out.append("\n".join(md))
        return out
