"""Entity and relation extraction feeding the knowledge-graph channel.

A copy of the JAX package's ``models/entity_extractor.py`` (rule backend and store),
so entity ids, relations and mentions come out equal in both packages:

- :class:`RuleBasedExtractor`: deterministic pattern NER (capitalized spans typed by
  organization / person / location / product cues, date and money regexes, code
  identifiers) and pattern relations ("X works for Y", ...) plus same-sentence
  RELATED_TO edges; entity and relation ids are ``uuid5`` of their keys. The
  reference's defects stay as they are (for example the relation-verb regex with no
  word boundaries).
- :class:`EntityStore`: upsert by canonical name, relations resolved to entity ids,
  mentions deduped per (entity, chunk), the trigram lookup that seeds the graph
  channel, and the global mention-linking sweep.

- :class:`CallableExtractor`: the LLM-backed adapter over ``fn(parent_text) ->
  {"entities": [...], "relations": [...]}`` (``models/http_clients.make_extractor_fn``),
  falling back to the rules on any failure or malformed payload.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..analyzer import strip_accents, trigrams
from ..config import RAGConfig, get_settings
from ..types import (
    ChildChunk,
    Entity,
    EntityMention,
    EntityType,
    ExtractionResult,
    ParentChunk,
    Relation,
    RelationType,
)

_ORG_SUFFIXES = (
    "corp", "corporation", "inc", "ltd", "llc", "sa", "s.a", "ltda", "gmbh", "company",
    "co", "group", "holdings", "bank", "university", "institute", "agency", "logistics",
    "systems", "technologies", "solutions", "me", "eireli", "epp",
    # org HEAD nouns (measured round 5, eval_results/ner_prose.json: un-suffixed
    # two-word orgs like "Acme Analytics" fell to the person default — business
    # orgs nearly always end in one of these)
    "solucoes", "consultoria", "engenharia", "servicos", "analytics", "partners",
    "capital", "holding", "associates", "consulting", "ventures", "industries",
    "enterprises", "labs", "laboratories", "foundation", "airlines", "motors",
    "pharma", "energia", "telecom", "seguros", "software", "ministerio",
    "secretaria", "prefeitura",
)
# Product-name head/tail nouns: "Orion Suite", "Falcon Engine" (EN, noun last)
# and "Plataforma Aurora", "Sistema Vega" (PT, noun first)
_PRODUCT_NOUNS = frozenset((
    "suite", "engine", "platform", "plataforma", "sistema", "painel", "modulo",
    "app", "api", "toolkit", "sdk",
))
_PERSON_TITLES = ("mr", "mrs", "ms", "dr", "prof", "sr", "sra", "dra", "eng")
# Common PT/BR + EN given names (accent-stripped): rule-NER gazetteer. Round-5
# prose eval showed the bare two-Titlecase-words -> PERSON default produced 1.4
# person FPs per true person ("Falcon Engine", "New York"); a first-name
# gazetteer is the standard rule-system fix (reference delegates this to GPT
# world knowledge, rag2/entity_extraction.py:104-148).
_GIVEN_NAMES = frozenset("""
maria jose joao ana antonio francisco carlos paulo pedro lucas luiz marcos
rafael daniel marcelo bruno eduardo felipe rodrigo gustavo gabriel fernando
ricardo tiago thiago diego vitor victor leonardo andre alexandre juliana
fernanda patricia aline camila amanda bruna leticia jessica beatriz larissa
mariana vanessa gabriela carolina sandra claudia regina marcia adriana
cristina simone luciana renata monica rosangela helena sofia alice laura
isabela manuela valentina cecilia clara lorena livia heloisa john james
robert michael william david richard joseph thomas charles christopher
matthew anthony mark donald steven paul andrew joshua kenneth kevin brian
george timothy ronald edward jason jeffrey ryan jacob gary nicholas eric
jonathan stephen larry justin scott brandon benjamin samuel gregory frank
alexander patrick jack dennis jerry tyler aaron henry douglas peter adam
nathan zachary walter kyle harold carl jordan mary jennifer linda elizabeth
barbara susan margaret lisa nancy karen betty dorothy sandra ashley kimberly
emily donna michelle carol amanda melissa deborah stephanie rebecca sharon
laura cynthia kathleen amy angela anna ruth brenda pamela nicole katherine
christine samantha catherine virginia rachel janet emma hannah olivia sarah
grace chloe lucy sophie
""".split())
_LEAD_ARTICLES = frozenset(("A", "O", "As", "Os", "The", "Um", "Uma"))
_LOC_CUE_WORDS = frozenset(("em", "in", "from", "near"))
_ORG_CUE_NOUNS = frozenset((
    "empresa", "company", "organizacao", "organization", "firma", "corporation",
    "startup", "fornecedor", "cliente",
))
_LOC_VERB_RE = re.compile(
    r"(?:located\s+in|based\s+in|localizada?\s+em|sediada\s+em|moved\s+to|"
    r"mudou\s+para)\s*$", re.IGNORECASE)

_CAP_SPAN_RE = re.compile(r"\b([A-ZÀ-Ý][\w&.\-À-ÿ]*(?:\s+(?:of|de|da|do|dos|das|e|and|&)?\s*[A-ZÀ-Ý][\w&.\-À-ÿ]*)*)\b")
# Code identifiers (the reference's LLM NER extracts these natively as TECHNOLOGY;
# entity_extraction.py:29-61 lists "technology" among its 15 types): dotted paths
# ("xml.dom.minidom", "asyncio.TaskGroup") and single identifiers cued by an
# appositive classifier noun ("the module asyncio", "a biblioteca numpy").
_CODE_ID_RE = re.compile(r"\b([A-Za-z_]\w*(?:\.[A-Za-z_]\w*)+)\b")
_MODULE_CUE_RE = re.compile(
    r"\b(?:module|package|library|class|função|modulo|módulo|pacote|biblioteca|classe)"
    r"\s+([A-Za-z_][\w.]*)\b"
)
# Prepositions marking an OBLIQUE entity (location/instrument adjunct, not the
# clause subject): a verb's left-attachment skips past these to the true
# subject ("A Acme, sediada EM Recife, faz parte de X" — subject is Acme).
_OBLIQUE_PREPS = frozenset((
    "em", "in", "de", "da", "do", "para", "por", "at", "from", "with", "com",
    "of", "to", "for",
))
# "S.A. oferece" — a single-capital abbreviation period followed by a
# lowercase continuation is NOT a sentence end; the naive splitter severed
# subjects from their verbs (round-5 prose eval rel_fn_examples)
_ABBREV_BREAK_RE = re.compile(r"\b[A-Z]\.\s*$")
_DATE_RE = re.compile(
    r"\b(\d{1,2}[/-]\d{1,2}[/-]\d{2,4}|\d{4}-\d{2}-\d{2}|"
    # optional PT day prefix "14 de maio ..."
    r"(?:\d{1,2}\s+de\s+)?"
    r"(?:january|february|march|april|may|june|july|august|september|october|november|"
    r"december|janeiro|fevereiro|março|marco|abril|maio|junho|julho|agosto|setembro|"
    # the day is OPTIONAL: month-name + year ("March 2024", "janeiro 2024") is the
    # dominant form in the contracts this taxonomy targets ({1,2}? was lazy, not
    # optional, and silently rejected day-less dates). PT interposes "de"
    # between month and year ("maio de 2019") — round-5 prose eval found the
    # missing "de" branch cost 27% of date recall (eval_results/ner_prose.json)
    r"outubro|novembro|dezembro)\s+(?:de\s+)?(?:\d{1,2},?\s+)?\d{4})\b",
    re.IGNORECASE,
)
_MONEY_RE = re.compile(r"(?:R?\$\s?[\d.,]+(?:\s?(?:million|billion|mil|milhões|bilhões))?|\b[\d.,]+\s?(?:dollars|reais|euros|USD|BRL|EUR)\b)")
_SENT_SPLIT_RE = re.compile(r"(?<=[.!?])\s+|\n+")

# relation patterns: (verb-phrase regex between two entity spans, type, swap).
# The verb regexes compile ONCE; per parent, each pattern with its verb present
# runs a single finditer over (entity-alternation) verb (entity-alternation) —
# O(patterns * len(text)) instead of the previous O(patterns * n_entities^2 *
# len(text)) per-pair scans (measured 1.1 s for ONE 26-entity parent)
_REL_PATTERNS: List[Tuple[str, RelationType, bool]] = [
    (r"(?:works?\s+for|trabalha\s+para|is\s+employed\s+by)", RelationType.WORKS_FOR, False),
    (r"(?:is\s+)?(?:located\s+in|based\s+in|localizada?\s+em|sediada\s+em)", RelationType.LOCATED_IN, False),
    (r"(?:is\s+part\s+of|belongs\s+to|faz\s+parte\s+de|pertence\s+a)", RelationType.PART_OF, False),
    (r"(?:produces|manufactures|produz|fabrica)", RelationType.PRODUCES, False),
    (r"(?:uses|usa|utiliza)", RelationType.USES, False),
    (r"(?:provides|offers|fornece|oferece)", RelationType.PROVIDES, False),
    (r"(?:depends\s+on|depende\s+de)", RelationType.DEPENDS_ON, False),
    (r"(?:signed\s+by|assinado\s+por)", RelationType.SIGNED_BY, False),
    (r"(?:costs|custa)", RelationType.COSTS, False),
]
_REL_VERB_RES = [(re.compile(mid, re.IGNORECASE), mid, rt, sw) for mid, rt, sw in _REL_PATTERNS]


def _fold_ws(text: str) -> str:
    """accent-strip + lowercase + whitespace-collapse: canonical_key's text space
    (double spaces/tabs from OCR or justified text must not break matching)."""
    return " ".join(strip_accents(text.lower()).split())


def _safe_conf(raw) -> float:
    try:
        return min(max(float(raw), 0.0), 1.0)
    except (TypeError, ValueError):
        return 0.8


def canonical_key(name: str) -> str:
    """Upsert key: accent-stripped, lowercased, whitespace-collapsed
    (reference upsert-by-(org_id, canonical_name), entity_extraction.py:449)."""
    return " ".join(strip_accents(name.lower()).split())


def _classify(span: str, preceding: str) -> EntityType:
    """Type a capitalized span from its own shape + the text before it.

    Cue order (round-5 prose eval, eval_results/ner_prose.json): org suffix >
    person title > location verb/preposition > org classifier noun > given-name
    gazetteer > multiword-org default. The old bare two-Titlecase-words ->
    PERSON rule (1.4 person FPs per true person: "Falcon Engine", "New York")
    is now gated on the gazetteer; locations were untypeable before the
    preposition cue (recall 0 -> cued)."""
    words = span.split()
    last = strip_accents(words[-1].lower().rstrip("."))
    first = strip_accents(words[0].lower())
    if len(words) >= 2 and (last in _PRODUCT_NOUNS or first in _PRODUCT_NOUNS):
        return EntityType.PRODUCT
    if last in _ORG_SUFFIXES:
        return EntityType.ORGANIZATION
    prev = strip_accents(preceding.lower().rstrip(". "))
    prev_words = prev.split()
    prev_last = prev_words[-1].rstrip(".,") if prev_words else ""
    if prev_last in _PERSON_TITLES:
        return EntityType.PERSON
    if _LOC_VERB_RE.search(preceding) or (
        prev_last in _LOC_CUE_WORDS and len(words) <= 3
    ):
        return EntityType.LOCATION
    if prev_last in _ORG_CUE_NOUNS:
        return EntityType.ORGANIZATION
    if (
        2 <= len(words) <= 3
        and strip_accents(words[0].lower()) in _GIVEN_NAMES
        and all(w[0].isupper() and w[1:].islower() for w in words)
    ):
        return EntityType.PERSON
    if len(words) >= 2:
        return EntityType.ORGANIZATION
    return EntityType.CONCEPT


class RuleBasedExtractor:
    """Deterministic pattern-based NER + RE over one parent chunk."""

    def __init__(self, config: Optional[RAGConfig] = None) -> None:
        self.config = config or get_settings()

    def extract(
        self, parent: ParentChunk, children: Sequence[ChildChunk]
    ) -> ExtractionResult:
        text = parent.text
        entities: Dict[str, Entity] = {}

        def add_entity(name: str, etype: EntityType) -> Optional[Entity]:
            name = name.strip(" .,;:")
            if len(name) < 2:
                return None
            key = canonical_key(name)
            if not key:
                return None
            ent = entities.get(key)
            if ent is None:
                ent = Entity(
                    entity_id=str(uuid.uuid5(uuid.NAMESPACE_OID, "thr-ent:" + key)),
                    canonical_name=name,
                    entity_type=etype,
                )
                entities[key] = ent
            return ent

        # capitalized spans (skip sentence-initial single lowercase-common words).
        # DATE/MONEY spans are masked out of the cap-span scan first — "July
        # 14, 2021" otherwise leaks a spurious "July" CONCEPT entity beside the
        # DATE (round-5 prose eval, eval_results/ner_prose.json fp_examples).
        for sent in _SENT_SPLIT_RE.split(text):
            masked = sent
            for dm in _DATE_RE.finditer(sent):
                masked = masked[: dm.start()] + " " * (dm.end() - dm.start()) + masked[dm.end():]
            for dm in _MONEY_RE.finditer(sent):
                masked = masked[: dm.start()] + " " * (dm.end() - dm.start()) + masked[dm.end():]
            for m in _CAP_SPAN_RE.finditer(masked):
                span = m.group(1)
                words = span.split()
                # strip a leading article glued in by the span regex ("A Cascata
                # Analytics está sediada ..." — the article is not part of the name)
                if len(words) >= 2 and words[0] in _LEAD_ARTICLES:
                    span = span[len(words[0]):].lstrip()
                    words = words[1:]
                if m.start() == 0 and len(words) == 1:
                    continue  # sentence-initial capital: ambiguous, skip single words
                if span.isupper() and len(span) <= 2:
                    continue
                add_entity(span, _classify(span, masked[: m.start()]))

        for m in _DATE_RE.finditer(text):
            add_entity(m.group(0), EntityType.DATE)
        for m in _MONEY_RE.finditer(text):
            add_entity(m.group(0), EntityType.MONEY)

        # code identifiers: dotted paths anywhere; bare identifiers only behind a
        # classifier-noun cue (a bare lowercase word is too ambiguous to be an
        # entity without one). DATE spans like "12.03.2024" never reach here —
        # the dotted pattern requires a non-digit lead character. Dotted
        # acronyms ("S.A.", "e.g") whose segments are all <= 2 chars are
        # punctuation artifacts, not identifiers.
        for m in _CODE_ID_RE.finditer(text):
            if all(len(seg) <= 2 for seg in m.group(1).split(".")):
                continue
            add_entity(m.group(1), EntityType.TECHNOLOGY)
        for m in _MODULE_CUE_RE.finditer(text):
            name = m.group(1).rstrip(".")
            if len(name) >= 2 and not name.isdigit():
                add_entity(name, EntityType.TECHNOLOGY)

        # relations: pattern-based, then same-sentence co-occurrence
        relations: List[Relation] = []
        seen_rel: set[Tuple[str, str, str]] = set()

        def add_relation(a: Entity, b: Entity, rtype: RelationType, conf: float) -> None:
            if a.entity_id == b.entity_id:
                return
            key = (a.entity_id, b.entity_id, rtype.value)
            if key in seen_rel:
                return
            seen_rel.add(key)
            relations.append(
                Relation(
                    relation_id=str(uuid.uuid5(uuid.NAMESPACE_OID, "thr-rel:" + "|".join(key))),
                    subject_id=a.entity_id,
                    object_id=b.entity_id,
                    relation_type=rtype,
                    confidence=conf,
                    source_chunk_id=parent.parent_id,
                )
            )

        ent_list = list(entities.values())
        if len(ent_list) >= 2:
            # longest-first alternation so "Acme Corp Holdings" wins over "Acme Corp"
            by_key = {canonical_key(e.canonical_name): e for e in ent_list}
            alt = "|".join(
                re.escape(e.canonical_name)
                for e in sorted(ent_list, key=lambda e: -len(e.canonical_name))
            )
            # One alternation scan collects every entity span; each verb match
            # then attaches to the NEAREST entity on each side within the same
            # sentence. Strict entity-verb-entity adjacency (the previous
            # construction) missed copulas ("A Acme ESTÁ sediada em ..."),
            # conjunction-reduced subjects ("... em Recife E faz parte de X" —
            # subject is the sentence head, not Recife), and interposed object
            # nouns ("oferece CONSULTORIA PARA a Vertex") — 39% of typed
            # relations on the round-5 prose set (eval_results/ner_prose.json).
            # An oblique left neighbor (preceded by a preposition) yields to
            # the nearest non-oblique entity further left.
            ent_span_re = re.compile(rf"\b({alt})\b", re.IGNORECASE)
            spans = [
                (m.start(), m.end(), by_key.get(canonical_key(m.group(1))))
                for m in ent_span_re.finditer(text)
            ]
            spans = [s for s in spans if s[2] is not None]
            sent_breaks = [
                m.start() for m in _SENT_SPLIT_RE.finditer(text)
                if not (
                    _ABBREV_BREAK_RE.search(text[: m.end()])
                    and text[m.end(): m.end() + 1].islower()
                )
            ]

            def sent_of(pos: int) -> int:
                return bisect.bisect_right(sent_breaks, pos)

            def left_entity(vstart: int):
                best = None
                for st, en, ent in reversed(spans):
                    if en > vstart:
                        continue
                    if vstart - en > 48 or sent_of(st) != sent_of(vstart):
                        break
                    prev_w = text[:st].rstrip().rsplit(None, 1)
                    oblique = bool(prev_w) and strip_accents(
                        prev_w[-1].lower().rstrip(".,")) in _OBLIQUE_PREPS
                    if not oblique:
                        return ent
                    if best is None:
                        best = ent  # fallback: oblique neighbor if nothing else
                return best

            def right_entity(vend: int):
                for st, en, ent in spans:
                    if st < vend:
                        continue
                    if st - vend > 48 or sent_of(st) != sent_of(vend):
                        return None
                    return ent
                return None

            if spans:
                for verb_re, mid, rtype, swap in _REL_VERB_RES:
                    for vm in verb_re.finditer(text):
                        a = left_entity(vm.start())
                        b = right_entity(vm.end())
                        if a is None or b is None or a is b:
                            continue
                        add_relation(b if swap else a, a if swap else b, rtype, 0.9)

        # co-occurrence in the same sentence -> weak RELATED_TO (canonical text
        # space: raw case/accent-sensitive substring dropped edges across
        # "ACME" / "Acme" variants the store treats as one entity)
        for sent in _SENT_SPLIT_RE.split(text):
            folded_sent = _fold_ws(sent)
            present = [
                e for key, e in entities.items() if key in folded_sent
            ]
            for i, a in enumerate(present):
                for b in present[i + 1 :]:
                    add_relation(a, b, RelationType.RELATED_TO, 0.5)

        # mentions: bind each entity to the child chunks whose text contains it
        # (whitespace-collapsed haystack: canonical keys collapse whitespace, so
        # "Acme  Corp" in OCR'd text must still bind)
        mentions: List[EntityMention] = []
        for child in children:
            lowered = _fold_ws(child.text)
            for key, ent in entities.items():
                if key in lowered:
                    mentions.append(
                        EntityMention(
                            entity_id=ent.entity_id,
                            chunk_id=child.chunk_id,
                            surface_form=ent.canonical_name,
                        )
                    )

        return ExtractionResult(entities=ent_list, mentions=mentions, relations=relations)


class CallableExtractor:
    """LLM-backed extraction adapter: ``fn(parent_text) -> {"entities": [...],
    "relations": [...]}`` in the reference prompt's JSON shape
    (entity_extraction.py:104-148); rule fallback on failure."""

    def __init__(self, fn: Callable[[str], dict], config: Optional[RAGConfig] = None) -> None:
        self.fn = fn
        self.config = config or get_settings()
        self._fallback = RuleBasedExtractor(self.config)

    def extract(self, parent: ParentChunk, children: Sequence[ChildChunk]) -> ExtractionResult:
        try:
            data = self.fn(parent.text)
            assert isinstance(data, dict)
            return self._parse(data, parent, children)
        except Exception:
            # the documented ladder covers MALFORMED payloads too (a list of
            # strings under "entities", "confidence": "high", ...) — any shape
            # violation degrades to rules instead of crashing the NER retry loop
            return self._fallback.extract(parent, children)

    def _parse(
        self, data: dict, parent: ParentChunk, children: Sequence[ChildChunk]
    ) -> ExtractionResult:
        entities: Dict[str, Entity] = {}
        for e in data.get("entities", []):
            name = str(e.get("name", "")).strip()
            if not name:
                continue
            key = canonical_key(name)
            try:
                etype = EntityType(str(e.get("type", "other")).lower())
            except ValueError:
                etype = EntityType.OTHER
            entities.setdefault(
                key,
                Entity(
                    entity_id=str(uuid.uuid5(uuid.NAMESPACE_OID, "thr-ent:" + key)),
                    canonical_name=name,
                    entity_type=etype,
                    description=str(e.get("description", "")),
                ),
            )

        relations: List[Relation] = []
        for r in data.get("relations", []):
            s = entities.get(canonical_key(str(r.get("subject", ""))))
            o = entities.get(canonical_key(str(r.get("object", ""))))
            if s is None or o is None or s is o:
                continue
            try:
                # the reference's JSON shape uses "relation_type"
                # (entity_extraction.py:286); accept "type" as an alias
                raw_type = r.get("relation_type", r.get("type", "related_to"))
                rtype = RelationType(str(raw_type).lower())
            except ValueError:
                rtype = RelationType.RELATED_TO
            relations.append(
                Relation(
                    relation_id=str(uuid.uuid4()),
                    subject_id=s.entity_id,
                    object_id=o.entity_id,
                    relation_type=rtype,
                    confidence=_safe_conf(r.get("confidence", 0.8)),
                    source_chunk_id=parent.parent_id,
                )
            )

        mentions: List[EntityMention] = []
        for child in children:
            lowered = _fold_ws(child.text)
            for key, ent in entities.items():
                if key in lowered:
                    mentions.append(
                        EntityMention(
                            entity_id=ent.entity_id,
                            chunk_id=child.chunk_id,
                            surface_form=ent.canonical_name,
                        )
                    )
        return ExtractionResult(
            entities=list(entities.values()), mentions=mentions, relations=relations
        )


@dataclass
class EntityStore:
    """Host-side triple store with reference upsert semantics
    (entity_extraction.py:364-554): the source the device graph index is built from."""

    entities: Dict[str, Entity] = field(default_factory=dict)  # canonical key -> entity
    _by_id: Dict[str, Entity] = field(default_factory=dict)
    relations: List[Relation] = field(default_factory=list)
    mentions: List[EntityMention] = field(default_factory=list)
    _rel_seen: set = field(default_factory=set)
    _men_seen: set = field(default_factory=set)

    @classmethod
    def from_items(cls, items: Iterable[Tuple[str, Entity]]) -> "EntityStore":
        """A store holding ``(canonical key, entity)`` rows in the given order (the
        carry-over of another store's entities, for lookups)."""
        store = cls()
        for key, ent in items:
            store.entities[key] = ent
            store._by_id[ent.entity_id] = ent
        return store

    def store_extraction(self, result: ExtractionResult) -> Dict[str, int]:
        remap: Dict[str, str] = {}
        n_new = 0
        for ent in result.entities:
            key = canonical_key(ent.canonical_name)
            existing = self.entities.get(key)
            if existing is None:
                self.entities[key] = ent
                self._by_id[ent.entity_id] = ent
                n_new += 1
            else:
                remap[ent.entity_id] = existing.entity_id
                if ent.aliases:
                    existing.aliases = tuple(set(existing.aliases) | set(ent.aliases))
        n_rel = 0
        for rel in result.relations:
            # remap into COPIES: mutating the caller's objects corrupted the
            # ExtractionResult for reuse (storing into a second store, or a
            # retry after a partial failure, saw already-remapped ids)
            sid = remap.get(rel.subject_id, rel.subject_id)
            oid = remap.get(rel.object_id, rel.object_id)
            if sid not in self._by_id or oid not in self._by_id:
                continue
            key = (sid, oid, rel.relation_type.value)
            if key in self._rel_seen:
                continue
            self._rel_seen.add(key)
            if sid != rel.subject_id or oid != rel.object_id:
                rel = dataclasses.replace(rel, subject_id=sid, object_id=oid)
            self.relations.append(rel)
            n_rel += 1
        n_men = 0
        for men in result.mentions:
            eid = remap.get(men.entity_id, men.entity_id)
            if eid not in self._by_id:
                continue
            key = (eid, men.chunk_id)
            if key in self._men_seen:
                continue
            self._men_seen.add(key)
            if eid != men.entity_id:
                men = dataclasses.replace(men, entity_id=eid)
            self.mentions.append(men)
            n_men += 1
        return {"entities": n_new, "relations": n_rel, "mentions": n_men}

    def entity_by_id(self, entity_id: str) -> Optional[Entity]:
        return self._by_id.get(entity_id)

    def link_mentions(self, children: Sequence[ChildChunk]) -> int:
        """Global entity-linking sweep: bind every KNOWN entity to every child chunk
        whose text contains its canonical key at word boundaries.

        Per-parent extraction only sees its own children, so an entity introduced in
        document A (e.g. an API index stating "class Foo belongs to the module bar")
        never gets mentions in document B (bar's own description) — exactly the
        cross-document link the graph channel needs to route a k-hop answer. This is
        the standard dictionary-linking pass of KG pipelines; the reference gets the
        same effect from Postgres ILIKE matching at graph-search time
        (rag2/graph_search.py:249-274). Word-boundary matching (not bare substring)
        keeps short keys ("os", "re") from binding inside unrelated words.
        Returns the number of new mentions added."""
        keys = sorted(self.entities, key=len, reverse=True)
        if not keys:
            return 0
        added = 0
        # First-word candidate index: a key matched by `(?<!\w)key(?!\w)` must
        # begin with its first maximal \w+ run appearing as a COMPLETE word
        # token of the text (the lookbehind bounds its start; the key's own next
        # non-word char bounds its end), so a child can only match keys whose
        # first token it contains. Grouping keys by first token and probing only
        # the child's own tokens makes the sweep O(children * tokens-per-child)
        # instead of O(children * all-keys) — the difference between ~1 s and
        # ~30 min at the 33k-doc corpus scale — with IDENTICAL match semantics
        # (each candidate still verified by its exact boundary regex).
        order = {k: i for i, k in enumerate(keys)}  # longest-first tie-stable
        singles: Set[str] = set()  # key == one \w+ run: token membership IS the
        # boundary match, no verification needed
        by_first: Dict[str, List[str]] = {}
        always_check: List[str] = []  # keys not led by a \w+ run (rare)
        key_toks: Dict[str, frozenset] = {}  # all \w+ runs of a multi-run key
        for k in keys:
            m = re.match(r"\w+", k)
            if m and m.group(0) == k:
                singles.add(k)
                continue
            (by_first.setdefault(m.group(0), []) if m else always_check).append(k)
            key_toks[k] = frozenset(re.findall(r"\w+", k))

        def _boundary_hit(folded: str, k: str) -> bool:
            # C-speed equivalent of (?<!\w)key(?!\w): the folded text is
            # accent-stripped/lowercased, so \w == alnum + underscore here.
            # Round-5 profile: the per-candidate regex scan made the sweep
            # O(candidates x text) with multi-thousand-key first-token buckets
            # at 92k entities — link_s was 2916 s at the 33k corpus.
            pos = folded.find(k)
            n = len(folded)
            while pos >= 0:
                b = folded[pos - 1] if pos > 0 else " "
                end = pos + len(k)
                a = folded[end] if end < n else " "
                if not (b.isalnum() or b == "_") and not (a.isalnum() or a == "_"):
                    return True
                pos = folded.find(k, pos + 1)
            return False

        for child in children:
            folded = _fold_ws(child.text)
            toks = set(re.findall(r"\w+", folded))
            cands: List[str] = [t for t in toks if t in singles]
            for k in always_check:
                if _boundary_hit(folded, k):
                    cands.append(k)
            for tok in toks:
                for k in by_first.get(tok, ()):
                    # every token of the key must be a token of the child
                    # (necessary for a boundary match; prunes the bucket to the
                    # handful of plausible keys before any text scan)
                    if key_toks[k] <= toks and _boundary_hit(folded, k):
                        cands.append(k)
            # longest keys first, exactly as the alternation-chunk sweep bound
            # them (mention order decides who survives the per-chunk entity cap)
            cands.sort(key=order.__getitem__)
            for k in cands:
                ent = self.entities.get(k)
                if ent is None:
                    continue
                mkey = (ent.entity_id, child.chunk_id)
                if mkey in self._men_seen:
                    continue
                self._men_seen.add(mkey)
                self.mentions.append(EntityMention(
                    entity_id=ent.entity_id, chunk_id=child.chunk_id,
                    surface_form=ent.canonical_name,
                ))
                added += 1
        return added

    def _trgm_index(self):
        """Trigram inverted index over canonical keys — the pg_trgm GIN-index analogue
        (reference entity-name trigram index, triple-hybrid-rag/database/schema.sql).
        Lookup cost is O(postings of the query's trigrams), not O(entities): at 20k+
        entities a fuzzy miss was a multi-ms full scan per name. Rebuilt lazily when
        the entity count changes (canonical keys are append-only)."""
        if getattr(self, "_trgm_n", -1) != len(self.entities):
            table: Dict[str, List[str]] = {}
            tsets: Dict[str, frozenset] = {}
            for k in self.entities:
                ts = trigrams(k)
                tsets[k] = ts
                for g in ts:
                    table.setdefault(g, []).append(k)
            self._trgm_table = table
            self._trgm_sets = tsets
            self._trgm_n = len(self.entities)
        return self._trgm_table, self._trgm_sets

    def lookup(self, name: str, fuzzy_threshold: float = 0.35) -> List[Entity]:
        """Exact canonical / substring / trigram-fuzzy entity lookup
        (replaces pg_trgm + PuppyGraph entity_lookup, puppygraph.py:182).
        Candidates come from the trigram inverted index; a substring pair of length
        >= 3 always shares interior trigrams, so substring matches surface there too."""
        key = canonical_key(name)
        exact = self.entities.get(key)
        if exact is not None:
            return [exact]
        if not key:
            return []
        table, tsets = self._trgm_index()
        qt = trigrams(key)
        counts: Dict[str, int] = {}
        for g in qt:
            for k in table.get(g, ()):
                counts[k] = counts.get(k, 0) + 1
        out = []
        for k, c in counts.items():
            if key in k or k in key:
                out.append((0.99, self.entities[k]))
                continue
            kt = tsets[k]
            sim = c / (len(qt) + len(kt) - c)  # jaccard from shared count
            if sim >= fuzzy_threshold:
                out.append((sim, self.entities[k]))
        out.sort(key=lambda x: -x[0])
        return [e for _, e in out]

    def stats(self) -> Dict[str, int]:
        return {
            "entities": len(self.entities),
            "relations": len(self.relations),
            "mentions": len(self.mentions),
        }

    # -- checkpoint support (non-executable serialization; see index/checkpoint.py) --

    def to_state(self) -> dict:
        return {
            "entities": list(self.entities.values()),
            "relations": list(self.relations),
            "mentions": list(self.mentions),
        }

    @classmethod
    def from_state(cls, state: dict) -> "EntityStore":
        store = cls()
        for ent in state["entities"]:
            store.entities[canonical_key(ent.canonical_name)] = ent
            store._by_id[ent.entity_id] = ent
        for rel in state["relations"]:
            store.relations.append(rel)
            store._rel_seen.add((rel.subject_id, rel.object_id, rel.relation_type.value))
        for men in state["mentions"]:
            store.mentions.append(men)
            store._men_seen.add((men.entity_id, men.chunk_id))
        return store
