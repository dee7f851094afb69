"""Host-side records of the query path (the subset of the JAX package's ``types.py``
that the port's engine produces and consumes). Field-for-field the reference's."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class Modality(str, enum.Enum):
    TEXT = "text"
    IMAGE = "image"
    TABLE = "table"
    MIXED = "mixed"


class EntityType(str, enum.Enum):
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


class SearchChannel(str, enum.Enum):
    LEXICAL = "lexical"
    SEMANTIC = "semantic"
    GRAPH = "graph"


@dataclass
class ParentChunk:
    """Context-window chunk (only the fields the decode step reads)."""

    parent_id: str
    doc_id: str
    text: str
    row: int = -1


@dataclass
class ChildChunk:
    """Retrieval-unit chunk (only the fields the decode step reads)."""

    chunk_id: str
    parent_id: str
    doc_id: str
    text: str
    modality: Modality = Modality.TEXT
    section_heading: Optional[str] = None
    page_start: int = 0
    page_end: int = 0
    row: int = -1


@dataclass
class Entity:
    entity_id: str
    canonical_name: str
    entity_type: EntityType = EntityType.OTHER
    aliases: Tuple[str, ...] = ()
    description: str = ""
    row: int = -1  # row in the adjacency arrays
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SearchResult:
    """One retrieved chunk with per-channel scores."""

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
    """Multi-channel retrieval plan."""

    original_query: str
    keywords: List[str] = field(default_factory=list)
    lexical_top_k: int = 50
    semantic_query_text: str = ""
    semantic_top_k: int = 100
    graph_entities: List[str] = field(default_factory=list)
    graph_query: Optional[object] = None
    graph_top_k: int = 50
    weights: Dict[str, float] = field(
        default_factory=lambda: {"lexical": 0.7, "semantic": 0.8, "graph": 1.0}
    )
    intent: str = "general"
    requires_graph: bool = False


@dataclass
class RetrievalResult:
    """Query-path output with timings."""

    query: str
    results: List[SearchResult] = field(default_factory=list)
    plan: Optional[QueryPlan] = None
    refused: bool = False
    refusal_reason: Optional[str] = None
    max_score: float = 0.0
    timings: Dict[str, float] = field(default_factory=dict)  # stage -> milliseconds
    channel_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def top_result(self) -> Optional[SearchResult]:
        return self.results[0] if self.results else None
