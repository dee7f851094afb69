"""Agent tool layer: ``search_knowledge_base`` and friends.

The port of the JAX package's ``tools.py``: a tool registry with JSON-schema'd
definitions (OpenAI-style function definitions, for wiring into any LLM
function-calling stack) and the knowledge-base tools over a
:class:`~triple_hybrid_rag_tpu_torch.facade.RAG`: ``search_knowledge_base`` (the
staged query, or the engine under ``use_sharded_engine``), ``lookup_entity`` (the
graph index's lookup API) and ``ingest_document``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .facade import RAG
from .observability import rag_metrics


@dataclass
class Tool:
    name: str
    description: str
    parameters: Dict[str, Any]  # JSON schema
    fn: Callable[..., Dict[str, Any]]

    def definition(self) -> Dict[str, Any]:
        """OpenAI-style function definition."""
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": self.parameters,
            },
        }


class ToolRegistry:
    """Named tool registry with dispatch."""

    def __init__(self) -> None:
        self._tools: Dict[str, Tool] = {}

    def register(self, tool: Tool) -> None:
        self._tools[tool.name] = tool

    def definitions(self) -> List[Dict[str, Any]]:
        return [t.definition() for t in self._tools.values()]

    def names(self) -> List[str]:
        return list(self._tools)

    def call(self, tool_name: str, /, **kwargs: Any) -> Dict[str, Any]:
        tool = self._tools.get(tool_name)
        if tool is None:
            return {"success": False, "error": f"unknown tool {tool_name!r}"}
        rag_metrics.counter("tool_calls_total").inc(labels={"tool": tool_name})
        try:
            return tool.fn(**kwargs)
        except Exception as e:
            rag_metrics.counter("tool_errors_total").inc(labels={"tool": tool_name})
            return {"success": False, "error": f"{type(e).__name__}: {e}"}


def make_knowledge_tools(rag: RAG) -> ToolRegistry:
    """Build the knowledge-base tool set over a RAG instance."""
    registry = ToolRegistry()

    def search_knowledge_base(
        query: str, top_k: Optional[int] = None, collection: Optional[str] = None
    ) -> Dict[str, Any]:
        """Answerable context chunks with channel provenance and timings, or a
        refusal."""
        result = rag.query(query, top_k=top_k, collection=collection)
        if result.refused:
            return {
                "success": False,
                "no_suitable_context": True,
                "reason": result.refusal_reason,
                "timings_ms": {k: round(v, 2) for k, v in result.timings.items()},
            }
        return {
            "success": True,
            "context": result.context_text,
            "sources": [
                {
                    "chunk_id": r.chunk_id,
                    "heading": r.section_heading,
                    "pages": [r.page_start, r.page_end],
                    "score": round(r.final_score, 4),
                    "channels": list(r.source_channels),
                    "text": r.text,
                }
                for r in result.results
            ],
            "timings_ms": {k: round(v, 2) for k, v in result.timings.items()},
        }

    registry.register(
        Tool(
            name="search_knowledge_base",
            description=(
                "Search the organization's knowledge base using triple-hybrid retrieval "
                "(keyword + semantic + knowledge-graph). Returns relevant context chunks "
                "or signals that no suitable context exists."
            ),
            parameters={
                "type": "object",
                "properties": {
                    "query": {"type": "string", "description": "natural-language question"},
                    "top_k": {"type": "integer", "description": "max results"},
                    "collection": {"type": "string", "description": "optional collection filter"},
                },
                "required": ["query"],
            },
            fn=search_knowledge_base,
        )
    )

    def lookup_entity(name: str) -> Dict[str, Any]:
        """Graph entity lookup: the best matches and their related entities."""
        gx = rag.retriever.graph_index
        if gx is None:
            return {"success": False, "error": "graph channel not enabled"}
        ents = gx.entity_lookup(name)
        return {
            "success": True,
            "entities": [
                {
                    "name": e.canonical_name,
                    "type": e.entity_type.value,
                    "related": [r.canonical_name for r in gx.related_entities(e.canonical_name)],
                }
                for e in ents[:5]
            ],
        }

    registry.register(
        Tool(
            name="lookup_entity",
            description="Look up an entity in the knowledge graph and list its relations.",
            parameters={
                "type": "object",
                "properties": {"name": {"type": "string"}},
                "required": ["name"],
            },
            fn=lookup_entity,
        )
    )

    def ingest_document(path: str, force: bool = False) -> Dict[str, Any]:
        res = rag.ingest(path, force=force)
        return {
            "success": res.status.value == "completed",
            "doc_id": res.doc_id,
            "skipped": res.skipped,
            "chunks": res.n_children,
            "entities": res.n_entities,
            "error": res.error,
        }

    registry.register(
        Tool(
            name="ingest_document",
            description="Ingest a document file into the knowledge base.",
            parameters={
                "type": "object",
                "properties": {
                    "path": {"type": "string"},
                    "force": {"type": "boolean"},
                },
                "required": ["path"],
            },
            fn=ingest_document,
        )
    )
    return registry
