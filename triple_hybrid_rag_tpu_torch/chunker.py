"""Hierarchical two-level chunker (host-side ingestion stage).

A copy of the JAX package's ``chunker.py``, so chunk ids, texts, offsets and pages
come out equal in both packages: parents of about 1000 tokens, children of about
200 with a 50-token overlap; recursive splitting over a separator hierarchy that
includes markdown headings; markdown tables replaced by placeholders before the
split and restored after, so a table is never cut; each chunk's most recent
heading; page provenance through a char-offset -> page map; token counts by the
``len(text) // 4`` estimate (or tiktoken's ``cl100k_base`` when ``use_tiktoken`` is
set and the package is installed); stable ids ``{doc_hash16}:{parent_idx}`` and
``{doc_hash16}:{parent_idx}:{child_idx}``, and content hashes for dedup.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from .config import RAGConfig, get_settings
from .types import ChildChunk, Modality, ParentChunk

# Separator hierarchy: coarse structure first, degrade to finer boundaries.
DEFAULT_SEPARATORS: Tuple[str, ...] = (
    "\n# ",
    "\n## ",
    "\n### ",
    "\n#### ",
    "\n\n",
    "\n",
    ". ",
    "? ",
    "! ",
    "; ",
    ", ",
    " ",
    "",
)

_HEADING_RE = re.compile(r"^(#{1,6})\s+(.+?)\s*$", re.MULTILINE)
_TABLE_ROW = re.compile(r"^\s*\|.*\|\s*$")
_TABLE_ROW_ANYWHERE = re.compile(r"^\s*\|.*\|\s*$", re.MULTILINE)
_PLACEHOLDER = "\x00THRTBL{}\x00"
_PLACEHOLDER_RE = re.compile(r"\x00THRTBL(\d+)\x00")


def estimate_tokens(text: str) -> int:
    """Cheap token estimate: ~4 chars/token (reference rag2/chunker.py:112)."""
    return max(1, len(text) // 4)


def make_token_counter(use_tiktoken: bool) -> Callable[[str], int]:
    if use_tiktoken:
        try:
            import tiktoken

            enc = tiktoken.get_encoding("cl100k_base")
            return lambda text: max(1, len(enc.encode(text)))
        except Exception:  # pragma: no cover - tiktoken baked in but be safe
            pass
    return estimate_tokens


# ---------------------------------------------------------------------------
# Table extraction (atomicity)
# ---------------------------------------------------------------------------


def extract_tables(text: str) -> Tuple[str, List[str]]:
    """Replace contiguous markdown-table line runs with placeholders.

    Returns (text_with_placeholders, tables). A run qualifies as a table when it spans
    >= 2 consecutive ``| ... |`` lines.
    """
    masked, tables, _ = extract_tables_spans(text)
    return masked, tables


def extract_tables_spans(
    text: str,
) -> Tuple[str, List[str], List[Tuple[int, int, int, int]]]:
    """Like :func:`extract_tables`, additionally returning placeholder span info.

    The third element is a list of ``(masked_start, masked_end, orig_start, orig_end)``
    tuples — one per placeholder, in document order — mapping each placeholder's span in
    the masked text back to the replaced table's span in the original text. This is what
    lets page/char provenance computed on masked offsets be projected back onto the
    original text (tables are usually much longer than their placeholders, so every
    offset after a table shifts).
    """
    lines = text.split("\n")
    out: List[str] = []
    tables: List[str] = []
    spans: List[Tuple[int, int, int, int]] = []
    orig_pos = 0  # char offset of lines[i] in the original text
    masked_pos = 0  # char offset of the next appended line in the masked text
    i = 0
    while i < len(lines):
        if _TABLE_ROW.match(lines[i]):
            j = i
            while j < len(lines) and _TABLE_ROW.match(lines[j]):
                j += 1
            if j - i >= 2:
                table = "\n".join(lines[i:j])
                tables.append(table)
                ph = _PLACEHOLDER.format(len(tables) - 1)
                spans.append((masked_pos, masked_pos + len(ph), orig_pos, orig_pos + len(table)))
                out.append(ph)
                masked_pos += len(ph) + 1  # +1 for the join "\n"
                orig_pos += len(table) + 1
                i = j
                continue
        out.append(lines[i])
        masked_pos += len(lines[i]) + 1
        orig_pos += len(lines[i]) + 1
        i += 1
    return "\n".join(out), tables, spans


def make_offset_mapper(
    spans: Sequence[Tuple[int, int, int, int]]
) -> Callable[[int], int]:
    """Build masked-offset -> original-offset projection from placeholder spans.

    Positions before/after each placeholder shift by the cumulative
    (table length - placeholder length) delta; positions *inside* a placeholder map to
    the table's start (the whole table is one atomic provenance unit).
    """
    if not spans:
        return lambda pos: pos

    def to_original(pos: int) -> int:
        delta = 0
        for m_start, m_end, o_start, o_end in spans:
            if pos < m_start:
                break
            if pos < m_end:
                return o_start
            delta = o_end - m_end
        return pos + delta

    return to_original


def restore_tables(text: str, tables: Sequence[str]) -> str:
    return _PLACEHOLDER_RE.sub(lambda m: tables[int(m.group(1))], text)


# ---------------------------------------------------------------------------
# Recursive splitter
# ---------------------------------------------------------------------------


@dataclass
class RecursiveSplitter:
    """Recursive character splitting over a separator hierarchy.

    Semantics (not code) follow the LangChain-style splitter the reference reimplements
    (``rag2/chunker.py:30-51,112``): try the coarsest separator that yields >1 piece, merge
    pieces greedily up to ``chunk_tokens``, recurse into oversized pieces with finer
    separators, and prefix each chunk after the first with ~``overlap_tokens`` of trailing
    context from its predecessor.
    """

    chunk_tokens: int
    overlap_tokens: int = 0
    separators: Tuple[str, ...] = DEFAULT_SEPARATORS
    token_counter: Callable[[str], int] = estimate_tokens

    def split_text(self, text: str) -> List[str]:
        pieces = self._merge_runts(self._split(text, 0))
        return self._apply_overlap(pieces)

    def _merge_runts(self, chunks: List[str]) -> List[str]:
        """Fold tiny fragments (e.g. a heading line split off alone) into a neighbor.

        A chunk under 1/8 of the budget joins the *following* chunk when the pair still fits,
        otherwise the previous one; a lone runt is kept as-is.
        """
        floor = max(1, self.chunk_tokens // 8)
        out: List[str] = []
        i = 0
        while i < len(chunks):
            cur = chunks[i]
            if self.token_counter(cur) < floor:
                if i + 1 < len(chunks) and self.token_counter(cur + chunks[i + 1]) <= int(
                    self.chunk_tokens * 1.1
                ):
                    chunks[i + 1] = cur + "\n" + chunks[i + 1]
                    i += 1
                    continue
                if out and self.token_counter(out[-1] + cur) <= int(self.chunk_tokens * 1.1):
                    out[-1] = out[-1] + "\n" + cur
                    i += 1
                    continue
            out.append(cur)
            i += 1
        return out

    # -- internals --

    def _split(self, text: str, sep_idx: int) -> List[str]:
        if self.token_counter(text) <= self.chunk_tokens or sep_idx >= len(self.separators):
            stripped = text.strip()
            return [stripped] if stripped else []

        sep = self.separators[sep_idx]
        if sep == "":
            return self._hard_split(text)
        parts = self._split_keep_sep(text, sep)
        if len(parts) <= 1:
            return self._split(text, sep_idx + 1)

        # Greedy merge of parts into chunks; oversized parts recurse with finer separators.
        chunks: List[str] = []
        buf: List[str] = []
        buf_tokens = 0
        for part in parts:
            pt = self.token_counter(part)
            if pt > self.chunk_tokens:
                if buf:
                    chunks.append("".join(buf).strip())
                    buf, buf_tokens = [], 0
                chunks.extend(self._split(part, sep_idx + 1))
                continue
            if buf_tokens + pt > self.chunk_tokens and buf:
                chunks.append("".join(buf).strip())
                buf, buf_tokens = [], 0
            buf.append(part)
            buf_tokens += pt
        if buf:
            chunks.append("".join(buf).strip())
        return [c for c in chunks if c]

    def _hard_split(self, text: str) -> List[str]:
        """Last resort: fixed-width character windows (~4 chars/token)."""
        width = max(8, self.chunk_tokens * 4)
        return [text[i : i + width].strip() for i in range(0, len(text), width) if text[i : i + width].strip()]

    @staticmethod
    def _split_keep_sep(text: str, sep: str) -> List[str]:
        """Split on ``sep``, keeping the separator attached to the *following* piece for
        newline-prefixed separators (so headings stay with their section) and to the
        *preceding* piece otherwise (so sentences keep their punctuation)."""
        if sep.startswith("\n"):
            raw = text.split(sep)
            return [raw[0]] + [sep + p for p in raw[1:]] if len(raw) > 1 else raw
        raw = text.split(sep)
        return [p + sep for p in raw[:-1]] + [raw[-1]] if len(raw) > 1 else raw

    def _apply_overlap(self, chunks: List[str]) -> List[str]:
        if self.overlap_tokens <= 0 or len(chunks) <= 1:
            return chunks
        overlap_chars = self.overlap_tokens * 4
        out = [chunks[0]]
        for prev, cur in zip(chunks, chunks[1:]):
            tail = prev[-overlap_chars:]
            # cut the tail at a word boundary so the overlap reads naturally
            sp = tail.find(" ")
            if 0 <= sp < len(tail) - 1:
                tail = tail[sp + 1 :]
            # placeholders must not be duplicated by overlap (table atomicity)
            if "\x00" in tail:
                tail = _PLACEHOLDER_RE.sub("", tail)
                if "\x00" in tail:
                    # the tail started MID-placeholder: a truncated remnant like
                    # "TBL7\x00" would be embedded and indexed — drop through the
                    # last NUL so only clean text survives
                    tail = tail[tail.rindex("\x00") + 1 :]
            out.append((tail + " " + cur).strip() if tail.strip() else cur)
        return out


# ---------------------------------------------------------------------------
# Hierarchical chunker
# ---------------------------------------------------------------------------


@dataclass
class HierarchicalChunker:
    """Document -> (parents, children) with headings, provenance, stable IDs."""

    config: RAGConfig = field(default_factory=get_settings)

    def __post_init__(self) -> None:
        counter = make_token_counter(self.config.use_tiktoken)
        self._count = counter
        self._parent_splitter = RecursiveSplitter(
            chunk_tokens=self.config.parent_chunk_tokens,
            overlap_tokens=0,
            token_counter=counter,
        )
        child_budget = int(
            self.config.child_chunk_tokens * (1.0 + self.config.child_token_buffer_pct)
        )
        self._child_splitter = RecursiveSplitter(
            chunk_tokens=child_budget,
            overlap_tokens=self.config.child_chunk_overlap_tokens,
            token_counter=counter,
        )

    def chunk_document(
        self,
        text: str,
        doc_id: str,
        page_map: Optional[Sequence[Tuple[int, int, int]]] = None,
    ) -> Tuple[List[ParentChunk], List[ChildChunk]]:
        """Split ``text`` into parent and child chunks.

        Args:
            text: full document text (markdown-ish).
            doc_id: document hash (stable-ID prefix uses its first 16 hex chars).
            page_map: optional list of (char_start, char_end, page_number) ranges.
        """
        doc_key = doc_id[:16]
        masked, tables, table_spans = extract_tables_spans(text)
        to_original = make_offset_mapper(table_spans)
        parent_texts = self._parent_splitter.split_text(masked)

        headings = self._heading_spans(masked)
        parents: List[ParentChunk] = []
        children: List[ChildChunk] = []
        cursor = 0
        for p_idx, p_masked in enumerate(parent_texts):
            # locate this parent in the masked text for heading/page attribution
            pos = masked.find(p_masked[:64], cursor)
            if pos < 0:
                pos = cursor
            cursor = pos + max(1, len(p_masked) // 2)
            heading = self._heading_for(headings, pos)
            # page_map offsets refer to the ORIGINAL text; project masked offsets back
            # through the table placeholders before page attribution.
            p_start, p_end = self._pages_for(
                page_map, to_original(pos), to_original(pos + len(p_masked)), text
            )

            p_text = restore_tables(p_masked, tables)
            parent = ParentChunk(
                parent_id=f"{doc_key}:{p_idx}",
                doc_id=doc_id,
                parent_idx=p_idx,
                text=p_text,
                section_heading=heading,
                page_start=p_start,
                page_end=p_end,
                token_count=self._count(p_text),
            )
            parents.append(parent)

            c_cursor = 0
            for c_idx, c_masked in enumerate(self._child_splitter.split_text(p_masked)):
                c_text = restore_tables(c_masked, tables)
                modality = Modality.TABLE if _TABLE_ROW_ANYWHERE.search(c_text) else Modality.TEXT
                # per-child attribution: a parent can span several sections and
                # pages — each child carries ITS OWN most-recent heading and page
                # projection (previously every child inherited the parent's,
                # misattributing whenever sections merged into one parent)
                c_pos = p_masked.find(c_masked[:48], c_cursor)
                if c_pos < 0:
                    c_pos = c_cursor
                c_cursor = c_pos + max(1, len(c_masked) // 2)
                c_abs = pos + c_pos
                c_heading = self._heading_for(headings, c_abs) or heading
                c_pstart, c_pend = self._pages_for(
                    page_map, to_original(c_abs), to_original(c_abs + len(c_masked)), text
                )
                children.append(
                    ChildChunk(
                        chunk_id=f"{doc_key}:{p_idx}:{c_idx}",
                        parent_id=parent.parent_id,
                        doc_id=doc_id,
                        parent_idx=p_idx,
                        child_idx=c_idx,
                        text=c_text,
                        modality=modality,
                        section_heading=c_heading,
                        page_start=c_pstart,
                        page_end=c_pend,
                        token_count=self._count(c_text),
                    )
                )
        return parents, children

    def create_image_chunk(
        self, doc_id: str, parent_idx: int, child_idx: int, caption: str, page: int = 0
    ) -> ChildChunk:
        """Image child chunk (standalone-lib parity, core/chunker.py:410)."""
        doc_key = doc_id[:16]
        return ChildChunk(
            chunk_id=f"{doc_key}:{parent_idx}:{child_idx}",
            parent_id=f"{doc_key}:{parent_idx}",
            doc_id=doc_id,
            parent_idx=parent_idx,
            child_idx=child_idx,
            text=caption,
            modality=Modality.IMAGE,
            page_start=page,
            page_end=page,
            token_count=self._count(caption) if caption else 0,
        )

    # -- attribution helpers --

    @staticmethod
    def _heading_spans(text: str) -> List[Tuple[int, str]]:
        return [(m.start(), m.group(2)) for m in _HEADING_RE.finditer(text)]

    @staticmethod
    def _heading_for(headings: List[Tuple[int, str]], pos: int) -> Optional[str]:
        current: Optional[str] = None
        for start, title in headings:
            if start <= pos + 8:  # heading at/just-before the chunk start counts
                current = title
            else:
                break
        return current

    @staticmethod
    def _pages_for(
        page_map: Optional[Sequence[Tuple[int, int, int]]],
        start: int,
        end: int,
        _text: str,
    ) -> Tuple[int, int]:
        if not page_map:
            return 0, 0
        pages = [p for s, e, p in page_map if s < end and e > start]
        if not pages:
            return page_map[0][2], page_map[0][2]
        return min(pages), max(pages)
