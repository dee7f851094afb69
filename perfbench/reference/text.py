"""The query side of the plain reference, written from the system's stated rules:
text analysis, the rule planner and the entity lookup that seeds the graph channel
(the query embedder is a model plug-in, ``reference/models/``).

It imports nothing of the program. The rules are those of the reference system's
host code (``analyzer.py``, ``models/planner.py`` ``RuleBasedPlanner``, the
function words that ``retrieval.py`` weights down in a query's tokens,
``EntityStore.lookup``) for the texts the traffic makes (ASCII; stored entity names), as they stand when this
benchmark was written; they are restated here so that a later change to the
program's copies shows as a disagreement instead of moving the yardstick with it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence

EN_STOPWORDS = frozenset(
    """a an and are as at be been but by for from had has have he her his i if in into is it its
    me my no nor not of on or our she so than that the their them then there these they this to
    up us was we were what when where which who whom why will with would you your""".split()
)
PT_STOPWORDS = frozenset(
    """a as ao aos aquela aquele com como da das de dela dele delas deles do dos e ela elas ele
    eles em entre era essa esse esta este eu foi ha isso isto ja la lhe mais mas me mesmo
    minha muito na nao nas nem no nos nossa nosso num numa o os ou para pela pelo por qual quando
    que quem sao se sem ser seu sua tambem te tem um uma voce vos""".split()
)
EN_OES_WORDS = frozenset(
    """shoes heroes echoes tomatoes potatoes goes does toes foes woes hoes
    oboes torpedoes dominoes volcanoes mosquitoes canoes vetoes embargoes
    cargoes mangoes haloes zeroes tornadoes buffaloes""".split()
)
FUNCTION_WORDS = frozenset(
    """get got make made take took tell told know knew want need find found
    explain say said see saw look give gave show list use used work help
    obter fazer feito dizer dito saber quis querer preciso precisa mostrar
    ajudar usar achar encontrar funciona funcionar""".split()
)
GRAPH_INDICATORS = (
    "relationship", "related", "connected", "connection", "between", "who", "what company",
    "which organization", "works for", "belongs to", "part of", "depends on", "relacionado",
    "relacionamento", "conectado", "entre", "quem", "qual empresa", "pertence",
    "trabalha para", "faz parte",
)
INDICATOR_RE = re.compile(r"\b(?:" + "|".join(re.escape(i) for i in GRAPH_INDICATORS) + r")\b")
PROCEDURAL = ("how do", "how to", "how can", "como fazer", "como posso", "como faço")
FACTUAL = ("what is", "what are", "define", "o que é", "o que sao", "o que são", "defina")
COMPARATIVE = ("difference", "compare", " vs ", "versus", "diferença", "comparar")
ENTITY_LOOKUP = ("who is", "who are", "quem é", "quem e", "quem sao", "quem são")
ENTITY_SPAN_RE = re.compile(
    r"\b([A-ZÀ-Ý][\wÀ-ÿ&-]*(?:\.[A-ZÀ-Ý][\wÀ-ÿ&-]*)*"
    r"(?:\s+[A-ZÀ-Ý][\wÀ-ÿ&-]*(?:\.[A-ZÀ-Ý][\wÀ-ÿ&-]*)*)*)\b"
)
NONENTITY_WORDS = frozenset(
    """how what who whom whose which when where why is are was were does do did can
    could will would should shall may might must list show find tell give explain
    describe compare the a an this that these those qual quais quem como onde quando
    quanto quantos liste mostre descreva compare explique o os as um uma umas uns
    este esta esse essa""".split()
)


def s_stem(token: str) -> str:
    """The light plural stemmer (Harman S-stemmer and a Portuguese -oes rule)."""
    n = len(token)
    if n > 4 and token.endswith("oes") and token not in EN_OES_WORDS:
        return token[:-3] + "ao"
    if n > 4 and token.endswith("ies") and token[-4] not in "ae":
        return token[:-3] + "y"
    if n > 3 and token.endswith("es") and token[-3] not in "aeo":
        return token[:-1]
    if n > 3 and token.endswith("s") and token[-2] not in "us":
        return token[:-1]
    return token


@dataclass
class TextRules:
    """The analyzer settings of a configuration (minimum token length, stemming)."""

    min_token_len: int = 2
    stemming: str = "light"
    stopwords: frozenset = EN_STOPWORDS | PT_STOPWORDS

    def tokenize(self, text: str) -> List[str]:
        """Lowercase ASCII alphanumeric runs, short tokens and stopwords dropped,
        stemmed. The traffic's texts are ASCII; the program's folding of accented
        letters is not modelled."""
        if not text.isascii():
            raise ValueError(f"the reference tokenizes ASCII text only: {text!r}")
        stem = s_stem if self.stemming == "light" else (lambda t: t)
        return [stem(t) for t in re.findall(r"[0-9a-z]+", text.lower())
                if len(t) >= self.min_token_len and t not in self.stopwords]

    def keywords(self, text: str, limit: int) -> List[str]:
        out: List[str] = []
        for t in self.tokenize(text):
            if t not in out:
                out.append(t)
            if len(out) >= limit:
                break
        return out

    def function_words(self) -> frozenset:
        out = set(FUNCTION_WORDS)
        for w in FUNCTION_WORDS:
            out.update(self.tokenize(w))
        return frozenset(out)


@dataclass
class Plan:
    keywords: List[str]
    entities: List[str]
    requires_graph: bool
    intent: str
    weights: Dict[str, float]


def entity_candidates(query: str) -> List[str]:
    """Capitalized spans, leading interrogatives and auxiliaries stripped; a lone
    sentence-initial capital counts only when shaped like an identifier."""
    out = []
    for sent in re.split(r"(?<=[.!?])\s+", query):
        first = True
        for m in ENTITY_SPAN_RE.finditer(sent):
            words = m.group(1).split()
            while words and words[0].lower() in NONENTITY_WORDS:
                words = words[1:]
            if not words:
                first = False
                continue
            s = " ".join(words)
            if " " not in s:
                if s.lower() in NONENTITY_WORDS:
                    first = False
                    continue
                if first and sent.strip().startswith(s):
                    shaped = any(c.isupper() for c in s[1:]) or any(c.isdigit() for c in s) or "." in s
                    if not shaped and query.count(s) < 2:
                        first = False
                        continue
            out.append(s)
            first = False
    return out


def plan(query: str, rules: TextRules, cfg: dict) -> Plan:
    """The rule planner: keywords, graph entities, graph need, intent, weights."""
    low = query.lower()
    keywords = rules.keywords(query, cfg["max_query_terms"])
    indicator = bool(INDICATOR_RE.search(low))
    entities = entity_candidates(query)
    requires_graph = indicator or len(entities) >= 2
    intent = "general"
    if low.startswith(ENTITY_LOOKUP):
        intent, requires_graph = "entity_lookup", True
    elif low.startswith(FACTUAL):
        intent = "factual"
    elif low.startswith(PROCEDURAL):
        intent = "procedural"
    elif any(m in low for m in COMPARATIVE):
        intent = "comparative"
    elif indicator:
        intent = "relational"
    graph_on = cfg["graph_enabled"]
    w = {
        "lexical": cfg["lexical_weight"],
        "semantic": cfg["semantic_weight"],
        "graph": cfg["graph_weight"] * (1.0 if requires_graph else 0.5),
    }
    if intent == "procedural":
        w["lexical"] = min(1.0, w["lexical"] + 0.1)
        w["semantic"] = min(1.0, w["semantic"] + 0.1)
    elif intent in ("relational", "entity_lookup") and entities and graph_on:
        w["lexical"] *= cfg["planner_relational_text_scale"]
        w["semantic"] *= cfg["planner_relational_text_scale"]
    return Plan(keywords, entities, requires_graph and graph_on, intent, w)


class EntityIndex:
    """Entity names -> rows by the exact canonical name (lowercased, whitespace
    collapsed). The traffic names only stored entities; the program's substring
    and trigram fallbacks for other names are not modelled."""

    def __init__(self, names: Sequence[str]) -> None:
        self.row_of = {" ".join(n.lower().split()): i for i, n in enumerate(names)}

    def lookup(self, name: str) -> List[int]:
        key = " ".join(name.lower().split())
        if key not in self.row_of:
            raise LookupError(f"the reference matches stored entity names only: {name!r}")
        return [self.row_of[key]]
