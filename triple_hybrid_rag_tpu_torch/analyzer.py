"""Text analysis: tokenization, normalization, stopwords, vocabulary.

A verbatim copy of the JAX package's ``analyzer.py`` (the port imports nothing from
that package), so query tokens — and therefore vocabulary ids, BM25 slots and hash
embeddings — match the reference bit for bit. The analyzer runs once per query on the
host; everything downstream is integer term ids on the device.

Normalization pipeline: lowercase -> accent strip (NFD, drop combining marks) -> regex word
tokens -> min-length filter -> bilingual (en+pt) stopword removal. No stemming by default:
Matryoshka-dense + graph channels cover morphology recall, and exactness helps BM25 precision.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence

from .config import RAGConfig, get_settings

# Compact bilingual stopword lists (mirroring the reference's PT/EN orientation,
# query_planner.py:199-227 and Postgres 'portuguese'/'english' FTS configs).
_EN_STOPWORDS = frozenset(
    """a an and are as at be been but by for from had has have he her his i if in into is it its
    me my no nor not of on or our she so than that the their them then there these they this to
    up us was we were what when where which who whom why will with would you your""".split()
)
_PT_STOPWORDS = frozenset(
    """a as ao aos aquela aquele com como da das de dela dele delas deles do dos e ela elas ele
    eles em entre era essa esse esta este eu foi ha isso isto ja la lhe mais mas me mesmo
    minha muito na nao nas nem no nos nossa nosso num numa o os ou para pela pelo por qual quando
    que quem sao se sem ser seu sua tambem te tem um uma voce vos""".split()
)

_TOKEN_RE = re.compile(r"[0-9a-zA-ZÀ-ɏ]+")
_ASCII_TOKEN_RE = re.compile(r"[0-9a-z]+")


def strip_accents(text: str) -> str:
    """NFD-decompose and drop combining marks (host-side; matches pg unaccent behavior)."""
    return "".join(c for c in unicodedata.normalize("NFD", text) if not unicodedata.combining(c))


# ---------------------------------------------------------------------------
# Canonical codepoint fold — the SINGLE tokenizer spec shared with the C++ fast
# path (native/thr_native.cpp kFold* tables are code-generated from fold_char;
# tests/test_native.py checks parity over every covered codepoint). An index
# built by either path is queryable by the other with identical vocab.
# ---------------------------------------------------------------------------

# Latin letters with no NFD decomposition, folded explicitly (single-char contract).
_EXPLICIT_FOLDS = {
    "ß": "s", "æ": "a", "ø": "o", "đ": "d", "ħ": "h",
    "ı": "i", "ĸ": "k", "ł": "l", "ŧ": "t",
}
# Codepoint ranges the fold table covers: Latin-1 Supplement + Latin Extended-A/B,
# and Latin Extended Additional (Vietnamese etc.). Everything else non-ASCII is a
# token separator in both tokenizers.
FOLD_RANGES = ((0xC0, 0x250), (0x1E00, 0x1F00))
COMBINING_RANGE = (0x300, 0x370)  # skipped (supports already-NFD'd input)


def fold_char(cp: int) -> str:
    """Fold one codepoint to its ASCII token char, or '' when it's a separator.

    Spec: lowercase -> NFD -> drop combining marks -> explicit fold for the
    non-decomposable Latin letters -> keep [0-9a-z]; first char when multi.
    """
    out = []
    for c in chr(cp).lower():
        for base in unicodedata.normalize("NFD", c):
            if unicodedata.combining(base):
                continue
            base = _EXPLICIT_FOLDS.get(base, base)
            if "0" <= base <= "9" or "a" <= base <= "z":
                out.append(base)
    return out[0] if out else ""


def _build_fold_table() -> dict:
    table: dict = {cp: None for cp in range(*COMBINING_RANGE)}  # delete combining marks
    for lo, hi in FOLD_RANGES:
        for cp in range(lo, hi):
            f = fold_char(cp)
            table[cp] = f if f else " "
    return table


_FOLD_TABLE = _build_fold_table()

# Common English -oes plurals the Portuguese -ões rule must not touch (the
# analyzer is bilingual: 'shoes' -> 'shao' would never match a 'shoe' query).
# PT plurals like nacoes/licoes/aviaoes are absent from this list and still
# fold to -ao. The lists can only collide on words valid in both languages,
# where either stem is self-consistent (index and query use the same rule).
_EN_OES_WORDS = frozenset(
    """shoes heroes echoes tomatoes potatoes goes does toes foes woes hoes
    oboes torpedoes dominoes volcanoes mosquitoes canoes vetoes embargoes
    cargoes mangoes haloes zeroes tornadoes buffaloes""".split()
)


def s_stem(token: str) -> str:
    """Light plural stemming (Harman S-stemmer + a Portuguese -oes rule).

    The reference's Postgres FTS applies full snowball stemming ('portuguese'/'english'
    configs); a conservative S-stemmer recovers most of that recall (receipts->receipt,
    contratos->contrato, nacoes->nacao) without over-stemming. Applied identically at
    index build and query time, so only consistency matters for ranking.
    """
    n = len(token)
    if (
        n > 4
        and token.endswith("oes")
        and token not in _EN_OES_WORDS  # 'shoes' must stem to 'shoe', not 'shao'
    ):  # accent-stripped -ções/-ões plurals
        return token[:-3] + "ao"
    if n > 4 and token.endswith("ies") and token[-4] not in "ae":
        return token[:-3] + "y"
    if n > 3 and token.endswith("es") and token[-3] not in "aeo":
        return token[:-1]
    if n > 3 and token.endswith("s") and token[-2] not in "us":
        return token[:-1]
    return token


def stem_family(token: str) -> str:
    """Aggressive morphological family key — for *matching*, never for indexing.

    Collapses verbal/plural inflections to a shared key (settled/settles/settling/
    settle -> "settl"; running/run -> "run") so the encoder's identity anchors
    (``models/encoder.py``) treat morphological variants as the same lexeme. Unlike
    :func:`s_stem` (which feeds the BM25 vocabulary and must stay conservative),
    over-stemming here only blends *anchor directions* — worst case a rare false
    conflation adds one spurious high token-similarity, it cannot corrupt an index.
    """
    t = s_stem(token)
    n = len(t)
    if n > 5 and t.endswith("ing"):
        t = t[:-3]
    elif n > 4 and t.endswith("ed"):
        t = t[:-2]
    elif n > 5 and t.endswith(("ava", "ando", "endo", "indo")):  # pt gerund/imperfect
        t = t[: -4 if t.endswith(("ando", "endo", "indo")) else -3]
    if len(t) > 3 and t.endswith("e"):
        t = t[:-1]  # settle -> settl (merges with settled/settling -> settl)
    if len(t) > 3 and t[-1] == t[-2]:
        t = t[:-1]  # runn -> run
    return t


@dataclass
class Analyzer:
    """Stateless text -> token-string pipeline."""

    config: RAGConfig = field(default_factory=get_settings)

    def __post_init__(self) -> None:
        stop: set[str] = set()
        if "en" in self.config.analyzer_languages:
            stop |= _EN_STOPWORDS
        if "pt" in self.config.analyzer_languages:
            stop |= _PT_STOPWORDS
        if self.config.analyzer_strip_accents:
            stop = {strip_accents(s) for s in stop}
        self._stopwords = frozenset(stop)

    def tokenize(self, text: str) -> List[str]:
        """Full pipeline: normalize, split, filter stopwords and short tokens, stem."""
        text = text.lower()
        if self.config.analyzer_strip_accents:
            # canonical fold (shared spec with the C++ fast path): accented Latin ->
            # ASCII base, non-decomposables via _EXPLICIT_FOLDS, rest are separators
            text = text.translate(_FOLD_TABLE)
            token_re = _ASCII_TOKEN_RE
        else:
            token_re = _TOKEN_RE
        min_len = self.config.analyzer_min_token_len
        stem = s_stem if self.config.analyzer_stemming == "light" else (lambda t: t)
        if self.config.analyzer_strip_accents:
            return [
                stem(t)
                for t in token_re.findall(text)
                if len(t) >= min_len and t not in self._stopwords
            ]
        # accents kept: the stopword list stores STRIPPED forms, so the test
        # folds the token just for membership ('não'/'são'/'você' must still
        # filter — they are the highest-frequency PT words)
        return [
            stem(t)
            for t in token_re.findall(text)
            if len(t) >= min_len
            and t not in self._stopwords
            and strip_accents(t) not in self._stopwords
        ]

    def keywords(self, query: str, max_keywords: int = 10) -> List[str]:
        """Stopword-filtered keyword extraction for query planning
        (reference core/query_planner.py:199-227 semantics: order-preserving, deduped)."""
        seen: set[str] = set()
        out: List[str] = []
        for t in self.tokenize(query):
            if t not in seen:
                seen.add(t)
                out.append(t)
            if len(out) >= max_keywords:
                break
        return out


class Vocabulary:
    """Append-only term <-> id mapping built at index time.

    Term id 0..V-1; out-of-vocabulary query terms map to -1 and are masked out on device.
    """

    def __init__(self) -> None:
        self._term_to_id: Dict[str, int] = {}
        self._terms: List[str] = []

    def __len__(self) -> int:
        return len(self._terms)

    def add(self, term: str) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._terms)
            self._term_to_id[term] = tid
            self._terms.append(term)
        return tid

    def get(self, term: str) -> int:
        """-1 if unknown (masked on device)."""
        return self._term_to_id.get(term, -1)

    def term(self, tid: int) -> str:
        return self._terms[tid]

    @property
    def terms(self) -> Sequence[str]:
        return self._terms

    def encode(self, tokens: Iterable[str], add: bool = False) -> List[int]:
        if add:
            return [self.add(t) for t in tokens]
        return [self.get(t) for t in tokens]

    # -- persistence (index checkpointing) --
    def to_list(self) -> List[str]:
        return list(self._terms)

    @classmethod
    def from_list(cls, terms: Sequence[str]) -> "Vocabulary":
        v = cls()
        for t in terms:
            v.add(t)
        return v


def term_frequencies(token_ids: Sequence[int]) -> Dict[int, int]:
    """tf map over one document's token ids (OOV -1 excluded)."""
    tf: Dict[int, int] = {}
    for t in token_ids:
        if t >= 0:
            tf[t] = tf.get(t, 0) + 1
    return tf


# Trigram utilities for fuzzy entity-name matching (replaces pg_trgm GIN index,
# reference triple-hybrid-rag/database/schema.sql entity-name trigram index).

def trigrams(s: str) -> frozenset[str]:
    if not s.strip():
        return frozenset()  # pg_trgm: empty input has NO trigrams (similarity 0)
    s = "  " + strip_accents(s.lower()) + " "
    return frozenset(s[i : i + 3] for i in range(len(s) - 2))


def trigram_similarity(a: str, b: str) -> float:
    """Jaccard similarity over character trigrams (pg_trgm `similarity()` analogue)."""
    ta, tb = trigrams(a), trigrams(b)
    if not ta or not tb:
        return 0.0
    return len(ta & tb) / len(ta | tb)
