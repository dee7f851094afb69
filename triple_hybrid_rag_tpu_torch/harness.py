"""Scenario-driven tool harness: batch-execute tools with validators + summary JSON.

The port of the JAX package's ``harness.py``: scenario definitions, a runner that
calls each scenario's tool on a :class:`~triple_hybrid_rag_tpu_torch.tools.ToolRegistry`
(the knowledge tools over a RAG on the card, or on the CPU with ``device="cpu"``),
validators as plain callables over the tool's JSON result, and a summary report
with per-scenario pass/fail and durations.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .tools import ToolRegistry

Validator = Callable[[Dict[str, Any]], Optional[str]]  # returns failure reason or None


@dataclass
class Scenario:
    name: str
    tool: str
    args: Dict[str, Any] = field(default_factory=dict)
    validators: List[Validator] = field(default_factory=list)


@dataclass
class ScenarioResult:
    scenario: str
    tool: str
    ok: bool
    duration_ms: float
    failures: List[str] = field(default_factory=list)
    output: Optional[Dict[str, Any]] = None


# -- common validators --


def expect_success(out: Dict[str, Any]) -> Optional[str]:
    return None if out.get("success") else f"tool failed: {out.get('error') or out.get('reason')}"


def expect_refusal(out: Dict[str, Any]) -> Optional[str]:
    return None if out.get("no_suitable_context") else "expected a refusal"


def expect_sources(min_count: int = 1) -> Validator:
    def check(out: Dict[str, Any]) -> Optional[str]:
        n = len(out.get("sources") or [])
        return None if n >= min_count else f"expected >= {min_count} sources, got {n}"

    return check


def expect_text_contains(needle: str) -> Validator:
    def check(out: Dict[str, Any]) -> Optional[str]:
        blob = json.dumps(out)
        return None if needle.lower() in blob.lower() else f"{needle!r} not in output"

    return check


class HarnessRunner:
    """Execute scenarios against a tool registry; collect a summary
    (per-scenario pass/fail + aggregate JSON)."""

    def __init__(self, registry: ToolRegistry) -> None:
        self.registry = registry

    def run(self, scenarios: List[Scenario]) -> Dict[str, Any]:
        results: List[ScenarioResult] = []
        for sc in scenarios:
            t0 = time.perf_counter()
            out = self.registry.call(sc.tool, **sc.args)
            dur = (time.perf_counter() - t0) * 1e3
            failures = [msg for v in sc.validators if (msg := v(out)) is not None]
            results.append(
                ScenarioResult(
                    scenario=sc.name, tool=sc.tool, ok=not failures,
                    duration_ms=dur, failures=failures, output=out,
                )
            )
        passed = sum(1 for r in results if r.ok)
        return {
            "total": len(results),
            "passed": passed,
            "failed": len(results) - passed,
            "results": [
                {
                    "scenario": r.scenario, "tool": r.tool, "ok": r.ok,
                    "duration_ms": round(r.duration_ms, 2), "failures": r.failures,
                }
                for r in results
            ],
        }


def default_scenarios() -> List[Scenario]:
    """The built-in scenario set over the knowledge tools (extend per deployment)."""
    return [
        Scenario(
            "kb_search_hit", "search_knowledge_base",
            {"query": "invoice settlement"},
            [expect_success, expect_sources(1)],
        ),
        Scenario(
            "kb_search_miss_refuses", "search_knowledge_base",
            {"query": "zzqx unanswerable gibberish"},
            [expect_refusal],
        ),
        Scenario(
            "entity_lookup", "lookup_entity",
            {"name": "Acme Corp"},
            [expect_success],
        ),
        Scenario(
            "unknown_tool_fails_closed", "no_such_tool", {},
            [lambda out: None if out.get("success") is False
             else "expected fail-closed (success=False) for unknown tool"],
        ),
    ]
