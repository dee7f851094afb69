"""Model layer: embedders, query planners, rerankers, entity extraction and the
HTTP model clients (the reference's ``models/__init__.py`` names).

The default models run in this process (the trained encoder on the card, the rule
planner and extractor on the host); the HTTP clients point any of them at an
external OpenAI-compatible server instead (``*_api_base``, :func:`wire_http_models`).
"""

from .embedder import BowHashEmbedder, Embedder, HashEmbedder
from .http_clients import (
    HTTPChatJSON,
    HTTPEmbedder,
    HTTPRerankerFn,
    HTTPVisionOCR,
    make_extractor_fn,
    make_planner_fn,
    wire_http_models,
)
from .planner import QueryPlanner, RuleBasedPlanner

__all__ = [
    "Embedder",
    "HashEmbedder",
    "BowHashEmbedder",
    "QueryPlanner",
    "RuleBasedPlanner",
    "HTTPEmbedder",
    "HTTPRerankerFn",
    "HTTPChatJSON",
    "HTTPVisionOCR",
    "make_planner_fn",
    "make_extractor_fn",
    "wire_http_models",
]
