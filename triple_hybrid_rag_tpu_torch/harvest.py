"""Docstring candidates of importable sources, for the quality evaluation.

The import half of the JAX package's docstring harvest (``eval._module_candidates``
and the per-module loop of ``eval._stdlib_documents``), kept apart from the torch
modules so that it can run in a process of its own: the package sources include
JAX packages (``jax``, ``chex``, ``haiku``, ``flax``, ``optax``), which must not be
loaded into the port's process, and packages with import side effects.
:func:`harvest_in_child` imports them in a child interpreter (this module run as a
script) and returns, per source and module, the candidates as JSON. The standard
library is harvested in the calling process (:func:`source_candidates`), as the
reference does. Importing this module loads neither numpy nor torch.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

Candidates = List[Tuple[str, str]]  # (name, stripped docstring) of one module


def module_candidates(source: str) -> List[str]:
    """Importable module names for one source ("stdlib" or a package name)."""
    if source == "stdlib":
        return [
            m for m in sorted(sys.stdlib_module_names)
            if not m.startswith("_") and m not in ("this", "antigravity")
        ]
    # a package plus its one-level submodules (the top two levels hold virtually
    # all user-facing docstrings)
    import pkgutil

    names = [source]
    try:
        pkg = importlib.import_module(source)
        for info in pkgutil.iter_modules(getattr(pkg, "__path__", []), f"{source}."):
            base = info.name.rsplit(".", 1)[-1]
            if not base.startswith("_") and base not in ("tests", "testing", "conftest"):
                names.append(info.name)
    except Exception:
        pass
    return names


def source_candidates(source: str, min_len: int) -> Iterator[Candidates]:
    """Per importable module of ``source``, in :func:`module_candidates` order: the
    module's docstring, then its attributes' (by name) that the source owns, each
    stripped, those shorter than ``min_len`` left out.

    Ownership as in the reference: re-exported modules, instances surfacing their
    type's docstring, and classes or functions whose ``__module__`` root lies
    outside the source (outside the standard library for "stdlib") are skipped."""
    stdlib_roots = set(sys.stdlib_module_names) | {"builtins"}
    for mod_name in module_candidates(source):
        try:
            m = importlib.import_module(mod_name)
        except Exception:
            continue
        cands = [(mod_name, (m.__doc__ or ""))]
        for attr_name, attr in sorted(vars(m).items()):
            if inspect.ismodule(attr):
                continue  # re-exported module: another source's prose
            d = getattr(attr, "__doc__", None)
            # equality, not identity: builtin getters return fresh strings
            if not isinstance(d, str) or d == getattr(type(attr), "__doc__", None):
                continue  # instance surfacing its type's docstring
            owner = getattr(attr, "__module__", None)
            if not isinstance(owner, str) or not owner:
                owner = mod_name  # C builtins / proxies without a str __module__
            root = owner.split(".")[0]
            if (root not in stdlib_roots) if source == "stdlib" else (root != source):
                continue  # defined in a foreign package, merely re-exported
            cands.append((f"{mod_name}.{attr_name}", d))
        yield [(name, text.strip()) for name, text in cands if len(text.strip()) >= min_len]


def harvest_in_child(sources: Sequence[str], min_len: int) -> Dict[str, List[Candidates]]:
    """:func:`source_candidates` of each source, in order, in a new interpreter
    (``sys.executable``): source -> the candidates of its modules. Raises with the
    child's error output if it fails."""
    if not sources:
        return {}
    root = str(Path(__file__).resolve().parents[1])
    code = (
        "import sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "from triple_hybrid_rag_tpu_torch.harvest import _child_main\n"
        "_child_main()\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(min_len), *sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"docstring harvest of {list(sources)} failed (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    return json.loads(proc.stdout)


def _child_main() -> None:
    """The child's side of :func:`harvest_in_child`: arguments ``min_len
    source...``; the JSON goes to the original standard output, and whatever the
    imports print (at the Python or the C level) to standard error."""
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    min_len, sources = int(sys.argv[1]), sys.argv[2:]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore")
        got = {s: list(source_candidates(s, min_len)) for s in sources}
    sys.stdout.flush()
    json.dump(got, out)
    out.close()
