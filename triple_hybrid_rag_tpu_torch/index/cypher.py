"""Cypher -> structured graph-op translation.

A copy of the JAX package's ``index/cypher.py`` (pure host code), so a query lowers
to the same op in both packages. An LLM planner that emits Cypher, as the system
this repository models does, drives the device graph through
:meth:`GraphIndex.execute_cypher
<triple_hybrid_rag_tpu_torch.index.graph_index.GraphIndex.execute_cypher>`: this
module parses the practical subset such a planner's graph layer uses (entity
match + variable-hop expansion + MENTIONED_IN -> Chunk, name CONTAINS lookups,
keyword IN matches, shortestPath) and lowers each shape onto the structured op
of :meth:`GraphIndex.execute_query`.

Supported shapes (case-insensitive keywords; single MATCH clause):

    MATCH (e:Entity {name: 'X'})-[*1..3]-(r) RETURN ...          -> neighborhood
    MATCH (e {name: 'X'})-[r]-(b) RETURN b                        -> related
    MATCH (e:Entity {name: 'X'}) RETURN e                         -> lookup
    MATCH (e) WHERE e.name CONTAINS 'X' RETURN e                  -> lookup
    MATCH (e) WHERE e.name IN ['a', 'b'] RETURN ...               -> keywords
    MATCH p = shortestPath((a {name:'X'})-[*..4]-(b {name:'Y'}))  -> path

`$param` placeholders resolve from the ``parameters`` dict. `LIMIT n` lowers to
the op's ``limit``. Anything outside the subset raises ``CypherTranslationError``
with the offending construct: fail loud, not wrong.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CypherTranslationError", "translate_cypher", "tokenize_cypher"]


class CypherTranslationError(ValueError):
    """Raised when a query falls outside the supported Cypher subset."""


_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
      | (?P<number>\d+)
      | (?P<param>\$[A-Za-z_][A-Za-z0-9_]*)
      | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<punct><-|->|\.\.|[(){}\[\],:.=*|-])
    )
    """,
    re.VERBOSE,
)


def tokenize_cypher(text: str) -> List[Tuple[str, str]]:
    """Lex a Cypher string into (kind, value) tokens; raises on junk."""
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        if text[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(text, pos)
        if not m or m.start() != pos:
            raise CypherTranslationError(
                f"unsupported character at {pos}: {text[pos:pos + 12]!r}"
            )
        kind = m.lastgroup or "punct"
        val = m.group(m.lastgroup)  # type: ignore[arg-type]
        if kind == "string":
            val = re.sub(r"\\(.)", r"\1", val[1:-1])
        tokens.append((kind, val))
        pos = m.end()
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]], params: Dict[str, Any]):
        self.toks = tokens
        self.i = 0
        self.params = params

    # -- token helpers -------------------------------------------------
    def peek(self, offset: int = 0) -> Tuple[str, str]:
        j = self.i + offset
        return self.toks[j] if j < len(self.toks) else ("eof", "")

    def next(self) -> Tuple[str, str]:
        t = self.peek()
        self.i += 1
        return t

    def kw(self, word: str) -> bool:
        k, v = self.peek()
        if k == "name" and v.upper() == word:
            self.i += 1
            return True
        return False

    def expect(self, value: str) -> None:
        k, v = self.next()
        if v != value and not (k == "name" and v.upper() == value.upper()):
            raise CypherTranslationError(f"expected {value!r}, got {v!r}")

    def value(self) -> Any:
        """A literal string/number or a $param resolved from parameters."""
        k, v = self.next()
        if k == "string":
            return v
        if k == "number":
            return int(v)
        if k == "param":
            name = v[1:]
            if name not in self.params:
                raise CypherTranslationError(f"unbound parameter ${name}")
            return self.params[name]
        raise CypherTranslationError(f"expected a literal or $param, got {v!r}")

    # -- grammar -------------------------------------------------------
    def node(self) -> Dict[str, Any]:
        """( var? (:Label)? ({props})? ) — returns {var, name?}."""
        self.expect("(")
        out: Dict[str, Any] = {"var": None, "name": None}
        k, v = self.peek()
        if k == "name":
            out["var"] = v
            self.i += 1
        if self.peek()[1] == ":":
            self.i += 1
            self.next()  # label — Entity/Chunk/anything; ignored
        if self.peek()[1] == "{":
            self.i += 1
            while self.peek()[1] != "}":
                pk, prop = self.next()
                if pk != "name":
                    raise CypherTranslationError(f"bad property key {prop!r}")
                self.expect(":")
                val = self.value()
                if prop.lower() in ("name", "id", "canonical_name"):
                    out["name"] = str(val)
                elif prop.lower() not in _SCOPING_PROPS:
                    # Same contract as _check_unconsumed: an inline property the
                    # device walk cannot honor (e.g. {type:'PERSON'}) must fail
                    # loud, not return an unfiltered superset.
                    raise CypherTranslationError(
                        f"inline node property {prop!r} is not translatable to the "
                        "device graph walk (only name/id/canonical_name and tenant "
                        "scoping properties are honored)"
                    )
                # tenant_id etc. are scoping no-ops on the single-tenant device
                # graph (collection masks handle scoping at retrieval time)
                if self.peek()[1] == ",":
                    self.i += 1
            self.expect("}")
        self.expect(")")
        return out

    def relationship(self) -> Optional[Dict[str, Any]]:
        """-[...]-, <-[...]-, -[...]->; returns {min_hops, max_hops} or None."""
        k, v = self.peek()
        if v not in ("-", "<-"):
            return None
        self.i += 1
        hops = {"min": 1, "max": 1}
        if self.peek()[1] == "[":
            self.i += 1
            # optional var, optional :TYPE(|TYPE)*, optional *min..max
            if self.peek()[0] == "name" and self.peek(1)[1] in (":", "*", "]"):
                self.next()
            if self.peek()[1] == ":":
                self.i += 1
                self.next()  # relation type — the device walk is type-blind
                while self.peek()[1] == "|":
                    self.i += 1
                    self.next()
            if self.peek()[1] == "*":
                self.i += 1
                hops["min"], hops["max"] = 1, 0  # 0 = unbounded-until-clamped
                if self.peek()[0] == "number":
                    hops["min"] = hops["max"] = int(self.next()[1])
                if self.peek()[1] == "..":
                    self.i += 1
                    hops["max"] = int(self.next()[1]) if self.peek()[0] == "number" else 0
            self.expect("]")
        self.expect("->" if self.peek()[1] == "->" else "-")
        return hops


def _where_clauses(p: _Parser) -> List[Dict[str, Any]]:
    """WHERE var.prop CONTAINS/=/IN value [AND ...] — list of clause dicts."""
    clauses: List[Dict[str, Any]] = []
    while True:
        k, var = p.next()
        if k != "name":
            raise CypherTranslationError(f"bad WHERE subject {var!r}")
        p.expect(".")
        _, prop = p.next()
        k2, op = p.peek()
        if k2 == "name" and op.upper() in ("CONTAINS", "IN"):
            p.i += 1
            if op.upper() == "IN":
                vals: List[Any] = []
                val = p.value() if p.peek()[1] != "[" else None
                if val is not None:  # $param bound to a list
                    vals = list(val) if isinstance(val, (list, tuple)) else [val]
                else:
                    p.expect("[")
                    while p.peek()[1] != "]":
                        vals.append(p.value())
                        if p.peek()[1] == ",":
                            p.i += 1
                    p.expect("]")
                clauses.append({"var": var, "prop": prop, "op": "in", "value": vals})
            else:
                clauses.append(
                    {"var": var, "prop": prop, "op": "contains", "value": p.value()}
                )
        elif op == "=":
            p.i += 1
            clauses.append({"var": var, "prop": prop, "op": "eq", "value": p.value()})
        else:
            raise CypherTranslationError(f"unsupported WHERE operator {op!r}")
        if not p.kw("AND"):
            break
    return clauses


# WHERE props the device graph scopes by other means: tenant/collection scoping
# happens via retrieval-time collection row masks, so these clauses are no-ops
# here by design (same treatment as tenant_id node properties above).
_SCOPING_PROPS = frozenset(
    {"tenant_id", "org_id", "organization_id", "collection", "collection_id"}
)


def _check_unconsumed(clauses: List[Dict[str, Any]], consumed: List[int]) -> None:
    """Fail loud on WHERE filters the structured op cannot honor.

    The device ops (lookup/related/neighborhood/path/keywords) carry no
    property-filter predicate, so silently dropping a clause would return an
    unfiltered superset — 'fail loud, not wrong' (module contract)."""
    for c in clauses:
        if id(c) in consumed or c["prop"].lower() in _SCOPING_PROPS:
            continue
        raise CypherTranslationError(
            f"unsupported WHERE filter {c['var']}.{c['prop']} {c['op']} ... — "
            "the device graph op cannot honor this predicate"
        )


def translate_cypher(
    cypher: str, parameters: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Lower a Cypher query (reference subset) to a structured graph op dict.

    The result feeds :meth:`GraphIndex.execute_query` unchanged. Raises
    :class:`CypherTranslationError` outside the subset.
    """
    params = dict(parameters or {})
    p = _Parser(tokenize_cypher(cypher), params)

    if not p.kw("MATCH"):
        raise CypherTranslationError("query must start with MATCH")

    # shortestPath((a)-[*..N]-(b)) — possibly bound `p =`
    if p.peek()[0] == "name" and p.peek(1)[1] == "=":
        p.i += 2
    is_path = p.peek()[0] == "name" and p.peek()[1].lower() == "shortestpath"
    if is_path:
        p.i += 1
        p.expect("(")
        a = p.node()
        hops = p.relationship()
        b = p.node()
        p.expect(")")
        if not a.get("name") or not b.get("name"):
            raise CypherTranslationError(
                "shortestPath endpoints need {name: ...} properties"
            )
        op: Dict[str, Any] = {"op": "path", "from": a["name"], "to": b["name"]}
        if hops and hops["max"]:
            op["max_hops"] = hops["max"]
        return op

    a = p.node()
    hops = p.relationship()
    b = p.node() if hops is not None else None
    # chained second hop e.g. -[:MENTIONED_IN]->(c:Chunk): the device op already
    # returns mention chunks, so a trailing chunk expansion is absorbed
    if b is not None and p.peek()[1] in ("-", "<-"):
        tail = p.relationship()
        if tail is not None:
            p.node()

    clauses: List[Dict[str, Any]] = []
    if p.kw("WHERE"):
        clauses = _where_clauses(p)

    limit: Optional[int] = None
    while p.peek()[0] != "eof":
        if p.kw("RETURN") or p.kw("ORDER") or p.kw("BY") or p.kw("WITH"):
            # projection list — names/stars/dots until LIMIT or eof
            continue
        if p.kw("LIMIT"):
            limit = int(p.value())
            continue
        p.i += 1  # projection tokens (vars, commas, functions) are irrelevant

    # name can come from the node properties or a WHERE clause on it
    name = a.get("name")
    name_clauses = [
        c for c in clauses
        if c["prop"].lower() in ("name", "id", "canonical_name")
    ]
    consumed: List[int] = []
    if name is None and name_clauses:
        c = name_clauses[0]
        consumed.append(id(c))
        if c["op"] == "in":
            _check_unconsumed(clauses, consumed)
            op = {"op": "keywords", "keywords": [str(v) for v in c["value"]]}
            if limit:
                op["limit"] = limit
            return op
        name = str(c["value"])
    _check_unconsumed(clauses, consumed)

    if name is None:
        raise CypherTranslationError(
            "could not determine a seed entity (need {name: ...} or WHERE .name)"
        )

    if hops is None:
        return {"op": "lookup", "entity": name}
    if hops["max"] == 1 and hops["min"] == 1:
        op = {"op": "related", "entity": name}
    else:
        op = {"op": "neighborhood", "entity": name}
        if hops["max"]:
            op["hops"] = hops["max"]
    if limit:
        op["limit"] = limit
    return op
