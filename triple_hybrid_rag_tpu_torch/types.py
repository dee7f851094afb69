"""Host-side records of the port: documents, two-level chunks, entities and
relations, query plans and results, ingestion outcomes.

A copy of the JAX package's ``types.py`` (field for field, with the same defaults),
so chunk ids, content hashes and entity ids come out equal in both packages. On the
device, chunks and entities are integer rows of capacity-padded tensors; the
``row`` fields bind the two.
"""

from __future__ import annotations

import enum
import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Enums (reference types.py:18-86)
# ---------------------------------------------------------------------------


class FileType(str, enum.Enum):
    PDF = "pdf"
    DOCX = "docx"
    TXT = "txt"
    MD = "md"
    CSV = "csv"
    XLSX = "xlsx"
    JSON = "json"
    HTML = "html"
    IMAGE = "image"
    UNKNOWN = "unknown"


class Modality(str, enum.Enum):
    TEXT = "text"
    IMAGE = "image"
    TABLE = "table"
    MIXED = "mixed"


class EntityType(str, enum.Enum):
    """Entity taxonomy (reference types.py:40-54 lists 12; rag2 adds more to reach 15)."""

    PERSON = "person"
    ORGANIZATION = "organization"
    LOCATION = "location"
    PRODUCT = "product"
    SERVICE = "service"
    EVENT = "event"
    DATE = "date"
    MONEY = "money"
    CONTRACT = "contract"
    CLAUSE = "clause"
    DOCUMENT = "document"
    CONCEPT = "concept"
    TECHNOLOGY = "technology"
    METRIC = "metric"
    OTHER = "other"


class RelationType(str, enum.Enum):
    """Relation taxonomy (reference types.py:56-68 lists 10; rag2 adds 3 more)."""

    WORKS_FOR = "works_for"
    LOCATED_IN = "located_in"
    PART_OF = "part_of"
    PRODUCES = "produces"
    USES = "uses"
    RELATED_TO = "related_to"
    MENTIONS = "mentions"
    HAS_CLAUSE = "has_clause"
    SIGNED_BY = "signed_by"
    EFFECTIVE_ON = "effective_on"
    COSTS = "costs"
    PROVIDES = "provides"
    DEPENDS_ON = "depends_on"


class IngestionStatus(str, enum.Enum):
    """Document state machine (reference schema 20260114_rag2_schema.sql:37)."""

    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"


class SearchChannel(str, enum.Enum):
    LEXICAL = "lexical"
    SEMANTIC = "semantic"
    GRAPH = "graph"


# ---------------------------------------------------------------------------
# Documents and chunks
# ---------------------------------------------------------------------------


def content_hash(text: str) -> str:
    """SHA-256 of whitespace-normalized content (reference rag2/chunker.py:99-109)."""
    normalized = " ".join(text.split()).lower()
    return hashlib.sha256(normalized.encode("utf-8")).hexdigest()


def file_hash_bytes(data: bytes) -> str:
    """SHA-256 of raw file bytes (reference rag2/ingest.py:165,204)."""
    return hashlib.sha256(data).hexdigest()


@dataclass
class Document:
    """A source document (reference types.py:90)."""

    doc_id: str  # = sha256 of file bytes (idempotency key)
    filename: str
    file_type: FileType = FileType.UNKNOWN
    collection: str = "default"
    status: IngestionStatus = IngestionStatus.PENDING
    n_pages: int = 0
    n_parents: int = 0
    n_children: int = 0
    created_at: float = field(default_factory=time.time)
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PageContent:
    """Per-page extracted content (reference types.py:114)."""

    page_number: int
    text: str
    modality: Modality = Modality.TEXT
    image_bytes: Optional[bytes] = None
    ocr_confidence: Optional[float] = None


@dataclass
class LoadedDocument:
    """Loader output (reference types.py:127)."""

    filename: str
    file_type: FileType
    pages: List[PageContent] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def full_text(self) -> str:
        return "\n\n".join(p.text for p in self.pages if p.text)


@dataclass
class ParentChunk:
    """Context-window chunk, 800-1000 tokens (reference types.py:142)."""

    parent_id: str  # "{doc_hash[:16]}:{parent_idx}"
    doc_id: str
    parent_idx: int
    text: str
    section_heading: Optional[str] = None
    page_start: int = 0
    page_end: int = 0
    token_count: int = 0
    hash: str = ""
    row: int = -1  # device row index (set at index build)

    def __post_init__(self) -> None:
        if not self.hash:
            self.hash = content_hash(self.text)


@dataclass
class ChildChunk:
    """Retrieval-unit chunk, ~200 tokens (reference types.py:168)."""

    chunk_id: str  # "{doc_hash[:16]}:{parent_idx}:{child_idx}"
    parent_id: str
    doc_id: str
    parent_idx: int
    child_idx: int
    text: str
    modality: Modality = Modality.TEXT
    section_heading: Optional[str] = None
    page_start: int = 0
    page_end: int = 0
    token_count: int = 0
    hash: str = ""
    row: int = -1  # device row index (set at index build)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.hash:
            self.hash = content_hash(self.text)


# ---------------------------------------------------------------------------
# Knowledge graph (reference types.py:207-272)
# ---------------------------------------------------------------------------


@dataclass
class Entity:
    entity_id: str
    canonical_name: str
    entity_type: EntityType = EntityType.OTHER
    aliases: Tuple[str, ...] = ()
    description: str = ""
    row: int = -1  # device row index in the adjacency arrays
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EntityMention:
    entity_id: str
    chunk_id: str
    surface_form: str = ""
    confidence: float = 1.0


@dataclass
class Relation:
    relation_id: str
    subject_id: str
    object_id: str
    relation_type: RelationType = RelationType.RELATED_TO
    confidence: float = 1.0
    source_chunk_id: Optional[str] = None


@dataclass
class ExtractionResult:
    """Output of entity/relation extraction over one parent chunk (reference types.py:427)."""

    entities: List[Entity] = field(default_factory=list)
    mentions: List[EntityMention] = field(default_factory=list)
    relations: List[Relation] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Query / results (reference types.py:274-390)
# ---------------------------------------------------------------------------


@dataclass
class SearchResult:
    """One retrieved chunk with per-channel scores (reference types.py:274)."""

    chunk_id: str
    parent_id: str
    doc_id: str
    text: str
    parent_text: Optional[str] = None
    section_heading: Optional[str] = None
    page_start: int = 0
    page_end: int = 0
    modality: Modality = Modality.TEXT
    lexical_score: float = 0.0
    semantic_score: float = 0.0
    graph_score: float = 0.0
    rrf_score: float = 0.0
    rerank_score: Optional[float] = None
    final_score: float = 0.0
    source_channels: Tuple[str, ...] = ()
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class QueryPlan:
    """Multi-channel retrieval plan (reference rag2/query_planner.py:23-49)."""

    original_query: str
    keywords: List[str] = field(default_factory=list)
    lexical_top_k: int = 50
    semantic_query_text: str = ""
    semantic_top_k: int = 100
    graph_entities: List[str] = field(default_factory=list)  # entity names for the graph channel
    # structured graph op (GraphIndex.execute_query shape) or raw query text;
    # LLM planners emitting the reference's cypher_query field get translated
    # to the structured op by CallablePlanner (index/cypher.py shim)
    graph_query: Optional[object] = None
    graph_top_k: int = 50
    weights: Dict[str, float] = field(
        default_factory=lambda: {"lexical": 0.7, "semantic": 0.8, "graph": 1.0}
    )
    intent: str = "general"  # factual | procedural | comparative | entity_lookup | relational
    requires_graph: bool = False


@dataclass
class RetrievalResult:
    """Full query-path output with per-stage timings (reference types.py:349, retrieval.py:139)."""

    query: str
    results: List[SearchResult] = field(default_factory=list)
    plan: Optional[QueryPlan] = None
    refused: bool = False
    refusal_reason: Optional[str] = None
    max_score: float = 0.0
    # stage -> host wall milliseconds; a device stage counts its launches, and its
    # kernels' time falls in the stage that next reads a result back
    timings: Dict[str, float] = field(default_factory=dict)
    channel_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def top_result(self) -> Optional[SearchResult]:
        return self.results[0] if self.results else None

    @property
    def context_text(self) -> str:
        """Concatenated parent texts for prompt assembly (reference types.py:381)."""
        seen: set[str] = set()
        parts: List[str] = []
        for r in self.results:
            text = r.parent_text or r.text
            key = r.parent_id or r.chunk_id
            if key in seen:
                continue
            seen.add(key)
            if r.section_heading:
                parts.append(f"## {r.section_heading}\n{text}")
            else:
                parts.append(text)
        return "\n\n---\n\n".join(parts)


@dataclass
class OCRResult:
    """OCR output (reference types.py:391)."""

    text: str
    confidence: float = 0.0
    mode: str = "base"
    tiles_used: int = 1
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class IngestionResult:
    """Ingestion outcome (reference types.py:413, rag2/ingest.py IngestStats)."""

    doc_id: str
    filename: str
    status: IngestionStatus
    n_pages: int = 0
    n_parents: int = 0
    n_children: int = 0
    n_entities: int = 0
    n_relations: int = 0
    n_mentions: int = 0
    n_deduped: int = 0
    skipped: bool = False  # idempotency: file hash already ingested
    error: Optional[str] = None
    timings: Dict[str, float] = field(default_factory=dict)
