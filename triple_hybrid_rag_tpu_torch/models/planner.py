"""Rule-based query planner: query -> multi-channel retrieval plan.

A copy of the JAX package's ``RuleBasedPlanner`` (rules backend only): keywords for the
lexical channel, the semantic query text, graph requirement and entity candidates,
intent, and per-channel weights. Deterministic host code, microseconds per query."""

from __future__ import annotations

import re
from typing import Optional, Protocol

from ..analyzer import Analyzer
from ..config import RAGConfig, get_settings
from ..types import QueryPlan

# Graph-benefit indicators (EN + PT), extending the reference's `_simple_plan` list.
_GRAPH_INDICATORS = (
    "relationship",
    "related",
    "connected",
    "connection",
    "between",
    "who",
    "what company",
    "which organization",
    "works for",
    "belongs to",
    "part of",
    "depends on",
    "relacionado",
    "relacionamento",
    "conectado",
    "entre",
    "quem",
    "qual empresa",
    "pertence",
    "trabalha para",
    "faz parte",
)
_GRAPH_INDICATOR_RE = re.compile(
    r"\b(?:" + "|".join(re.escape(i) for i in _GRAPH_INDICATORS) + r")\b"
)

_PROCEDURAL_PREFIXES = ("how do", "how to", "how can", "como fazer", "como posso", "como faço")
_FACTUAL_PREFIXES = ("what is", "what are", "define", "o que é", "o que sao", "o que são", "defina")
_COMPARATIVE_MARKERS = ("difference", "compare", " vs ", "versus", "diferença", "comparar")
_ENTITY_LOOKUP_PREFIXES = ("who is", "who are", "quem é", "quem e", "quem sao", "quem são")

# Capitalized multi-word spans (naive proper-noun detection for graph seeding).
# No '.' in the char class and spans never cross sentence punctuation — a dot
# glued "Paris. London" into one bogus entity; dotted acronyms keep internal
# dots via the optional (?:\.[A-Z][\wÀ-ÿ&-]*)* tail.
_ENTITY_SPAN_RE = re.compile(
    r"\b([A-ZÀ-Ý][\wÀ-ÿ&-]*(?:\.[A-ZÀ-Ý][\wÀ-ÿ&-]*)*"
    r"(?:\s+[A-ZÀ-Ý][\wÀ-ÿ&-]*(?:\.[A-ZÀ-Ý][\wÀ-ÿ&-]*)*)*)\b"
)

# Interrogatives / auxiliaries / verbs / articles that appear capitalized at sentence
# start but are never entity names (EN + PT; mirrors the reference planner's stop-word
# slant). Articles matter: "The class Foo ..." must seed "Foo", not "The" — a spurious
# leading candidate burns a fuzzy entity_lookup and graph seed slots ahead of the real
# entity (round-3 advisor finding).
_NONENTITY_WORDS = frozenset(
    """how what who whom whose which when where why is are was were does do did can
    could will would should shall may might must list show find tell give explain
    describe compare the a an this that these those qual quais quem como onde quando
    quanto quantos liste mostre descreva compare explique o os as um uma umas uns
    este esta esse essa""".split()
)


class QueryPlanner(Protocol):
    """Planner interface; both rule-based and LLM-backed planners satisfy it."""

    def plan(self, query: str, collection: Optional[str] = None) -> QueryPlan:
        ...


class RuleBasedPlanner:
    """Deterministic heuristic planner (default backend)."""

    def __init__(self, config: Optional[RAGConfig] = None) -> None:
        self.config = config or get_settings()
        self._analyzer = Analyzer(self.config)

    def plan(self, query: str, collection: Optional[str] = None) -> QueryPlan:
        lowered = query.lower()
        keywords = self._analyzer.keywords(query, max_keywords=self.config.max_query_terms)

        # word-boundary matching: raw substrings flipped requires_graph on
        # unrelated words ("whole" contains "who", "entrepreneurs"/"entrevista"
        # contain PT "entre")
        indicator = bool(_GRAPH_INDICATOR_RE.search(lowered))
        entities = self._entity_candidates(query)
        # two entity candidates ENABLE the graph channel, but only explicit
        # relational phrasing (the indicator list / entity-lookup prefixes)
        # earns relational INTENT and its text-channel demotion: prose with two
        # incidental capitals ("Models passed to accumulate() will ... Example
        # ... Accelerator") must not have its lexical/semantic voice halved —
        # 27% of held-out cloze queries tripped that at 33k-corpus scale and
        # full-pipeline recall fell 15pp below the graph-off config. Matches the
        # reference's rule fallback, which keys requires_graph on indicator
        # words alone (rag2/query_planner.py:130-190 _simple_plan).
        requires_graph = indicator or len(entities) >= 2

        intent = "general"
        if lowered.startswith(_ENTITY_LOOKUP_PREFIXES):
            intent = "entity_lookup"
            requires_graph = True
        elif lowered.startswith(_FACTUAL_PREFIXES):
            intent = "factual"
        elif lowered.startswith(_PROCEDURAL_PREFIXES):
            intent = "procedural"
        elif any(m in lowered for m in _COMPARATIVE_MARKERS):
            intent = "comparative"
        elif indicator:
            intent = "relational"

        weights = {
            "lexical": self.config.lexical_weight,
            "semantic": self.config.semantic_weight,
            # graph weight halves when the query shows no graph shape
            # (reference _simple_plan semantics; scaled by the CONFIGURED weight —
            # a hard-coded 0.5 inverted the ordering whenever graph_weight < 0.5)
            "graph": self.config.graph_weight * (1.0 if requires_graph else 0.5),
        }
        if intent == "procedural":
            # procedural queries lean on exact keyword matches (reference planner prompt
            # example raises lexical/semantic for procedural intent)
            weights["lexical"] = min(1.0, weights["lexical"] + 0.1)
            weights["semantic"] = min(1.0, weights["semantic"] + 0.1)
        elif (
            intent in ("relational", "entity_lookup")
            and entities
            and self.config.graph_enabled
        ):
            # gate on graph_enabled: demoting the text channels only makes sense
            # when the graph channel can compensate (round-3 advisor finding —
            # the uniform scaling was ordering-invariant only by accident)
            # relation-mediated answers share only function words with the query:
            # demote the text channels so two-channel agreement on a stop-word
            # match cannot out-sum a single-channel graph hit (the reference's
            # LLM planner adapts weights per intent the same way,
            # rag2/query_planner.py:54-94; see config.planner_relational_text_scale)
            s = self.config.planner_relational_text_scale
            weights["lexical"] *= s
            weights["semantic"] *= s

        return QueryPlan(
            original_query=query,
            keywords=keywords,
            lexical_top_k=self.config.lexical_top_k,
            semantic_query_text=query,
            semantic_top_k=self.config.semantic_top_k,
            graph_entities=entities,
            graph_query=None,
            graph_top_k=self.config.graph_top_k,
            weights=weights,
            intent=intent,
            requires_graph=requires_graph and self.config.graph_enabled,
        )

    def _entity_candidates(self, query: str) -> list[str]:
        """Capitalized spans, excluding leading interrogatives/auxiliaries."""
        out = []
        for sent in re.split(r"(?<=[.!?])\s+", query):
            first_span = True
            for m in _ENTITY_SPAN_RE.finditer(sent):
                s = m.group(1)
                # strip leading interrogatives/aux verbs capitalized by sentence
                # position ("Does Microsoft own GitHub?" seeds "Microsoft", not
                # "Does Microsoft")
                words = s.split()
                while words and words[0].lower() in _NONENTITY_WORDS:
                    words = words[1:]
                if not words:
                    first_span = False
                    continue
                s = " ".join(words)
                if " " not in s:
                    if s.lower() in _NONENTITY_WORDS:
                        first_span = False
                        continue
                    if first_span and sent.strip().startswith(s):
                        # sentence-initial single capital: plain Titlecase here
                        # is just sentence case ("Models passed to ...", "By
                        # default ..."), not a name. Keep it only when the word
                        # is identifier-shaped (a second uppercase, digit, or
                        # dot: "CreateJoint", "NASA", "B2", "numpy.linalg") or
                        # recurs capitalized elsewhere in the query.
                        shaped = (
                            any(c.isupper() for c in s[1:])
                            or any(c.isdigit() for c in s)
                            or "." in s
                        )
                        if not shaped and query.count(s) < 2:
                            first_span = False
                            continue
                out.append(s)
                first_span = False
        return out


def get_planner(config: Optional[RAGConfig] = None) -> QueryPlanner:
    """The rules backend (the only one the port has)."""
    return RuleBasedPlanner(config or get_settings())
