"""The port's public surface covers the reference's, one case per reference module.

For every module of the JAX package (less ``ops/pallas/``, whose kernels the port
replaces with its own), the reference's source is read with ``ast`` and each public
top-level function, class, method, dataclass field (also the fields of a flax
``nn.Module`` or a ``NamedTuple``) and module constant (an upper-case top-level
name) must exist in the port's module of the same path. Each function and method
must accept every parameter name the reference's accepts; the port may add its
own (``device``, ``results``, ...). A dataclass field must be a field of the
port's class or an attribute of the class itself, so a keyword construction or a
class-level read works as in the reference. ``__all__``, where the reference
defines one, must be covered by the port's.

``EXCEPTIONS`` lists what the port deliberately does otherwise, each with its
reason; an entry that no longer differs fails the test, so the list stays exact.
"""

import ast
import dataclasses
import importlib
import inspect
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "triple_hybrid_rag_tpu"
CONSTANT = re.compile(r"^[A-Z][A-Z0-9_]*$")

EXCEPTIONS = {
    ("cli", "func cmd_bench"):
        "benchmark work: `thr bench` runs bench.py, earlier work's benchmark of the TPU",
    ("ops.maxsim", "params maxsim_scores"):
        "the kernel's entry keeps its gather contract (store, mask, parent ids, query, "
        "weights); the reference's single-query form is maxsim_scores_batch on a "
        "leading axis of 1 (ROADMAP Queue 3, Limits)",
    ("models.encoder", "field Encoder.cfg"):
        "a flax nn.Module attribute; the torch module holds it on the instance",
    ("models.encoder", "field Block.cfg"):
        "a flax nn.Module attribute; the torch module holds it on the instance",
    ("models.visual_align", "field VisualEncoder.cfg"):
        "a flax nn.Module attribute; the torch module holds it on the instance",
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module's imports run, as the other port
    modules pin it; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_modules():
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).with_suffix("")
        if "pallas" in rel.parts:
            continue
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _params(fn: ast.FunctionDef, drop_first: bool):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args]
    if drop_first and names:
        names = names[1:]
    return names + [x.arg for x in a.kwonlyargs]


def _fieldy(cls: ast.ClassDef) -> bool:
    decorated = any("dataclass" in ast.unparse(d) for d in cls.decorator_list)
    bases = [ast.unparse(b) for b in cls.bases]
    return decorated or any(b.endswith("Module") or b.endswith("NamedTuple") for b in bases)


def surface(path: Path):
    """(kind, name, member, parameter names) of the reference module's public
    definitions."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.append(("func", node.name, None, _params(node, False)))
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.append(("class", node.name, None, None))
            fieldy = _fieldy(node)
            for sub in node.body:
                if isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    if fieldy and "ClassVar" not in ast.unparse(sub.annotation):
                        out.append(("field", node.name, sub.target.id, None))
                elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if sub.name.startswith("_") and sub.name != "__init__":
                        continue
                    decs = [ast.unparse(d) for d in sub.decorator_list]
                    if any(d == "property" or d.endswith(".setter") for d in decs):
                        out.append(("attr", node.name, sub.name, None))
                    else:
                        out.append(("method", node.name, sub.name,
                                    _params(sub, "staticmethod" not in decs)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out += [("const", t.id, None, None) for t in targets
                    if isinstance(t, ast.Name) and CONSTANT.match(t.id)]
    return out


def _refused(obj, names):
    """The names among ``names`` that ``obj``'s signature does not accept."""
    params = inspect.signature(obj).parameters
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return []
    return [n for n in names if n not in params]


def _all_names(path: Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            return set(ast.literal_eval(node.value))
    return None


def differences(module: str, path: Path):
    """Each way the port's module falls short of the reference's surface."""
    port = importlib.import_module("triple_hybrid_rag_tpu_torch" + ("." + module if module else ""))
    found = []
    ref_all = _all_names(path)
    if ref_all is not None:
        port_all = set(getattr(port, "__all__", ()))
        found += [f"__all__ {n}" for n in sorted(ref_all - port_all)]
    for kind, name, member, params in surface(path):
        if kind in ("func", "class", "const"):
            if not hasattr(port, name):
                found.append(f"{kind} {name}")
            elif kind == "func" and _refused(getattr(port, name), params):
                found.append(f"params {name}")
            continue
        cls = getattr(port, name, None)
        if cls is None:
            continue  # the class itself is reported
        if kind == "field":
            fields = {f.name for f in dataclasses.fields(cls)} if dataclasses.is_dataclass(cls) else set()
            if member not in fields and not hasattr(cls, member):
                found.append(f"field {name}.{member}")
        elif not hasattr(cls, member):
            found.append(f"{kind} {name}.{member}")
        elif kind == "method" and not (member == "__init__" and dataclasses.is_dataclass(cls)):
            fn = inspect.getattr_static(cls, member)
            fn = getattr(fn, "__func__", fn)
            bad = [n for n in _refused(fn, params) if n not in ("self", "cls")]
            if bad:
                found.append(f"params {name}.{member}")
    return found


MODULES = list(_reference_modules())


@pytest.mark.parametrize("module,path", MODULES, ids=[m or "root" for m, _ in MODULES])
def test_port_covers_the_reference_surface(module, path):
    assert (ROOT / "triple_hybrid_rag_tpu_torch" / path.relative_to(REF)).exists(), module
    found = set(differences(module, path))
    excused = {what for (mod, what) in EXCEPTIONS if mod == module}
    assert found - excused == set(), f"the port lacks {sorted(found - excused)}"
    assert excused - found == set(), f"no longer differs, drop from EXCEPTIONS: {sorted(excused - found)}"


def test_the_scan_sees_the_surface():
    """The scan finds what it claims to: functions with their parameters, methods
    without ``self``, dataclass and flax fields, properties and constants."""
    bm25 = {(k, n, m) for k, n, m, _ in surface(REF / "index" / "bm25_index.py")}
    assert ("field", "BM25Index", "host_csr") in bm25
    assert ("method", "BM25Index", "search") in bm25 and ("func", "build_bm25_index", None) in bm25
    encoder = {(k, n, m): p for k, n, m, p in surface(REF / "models" / "encoder.py")}
    assert ("field", "Encoder", "cfg") in encoder
    assert encoder[("func", "init_encoder", None)] == ["enc_cfg", "seed"]
    assert ("attr", "EncoderEmbedder", "maxsim_calibration") in encoder
    assert encoder[("method", "EncoderEmbedder", "__init__")][0] == "enc_cfg"
    assert ("const", "DATA_DIR", None) in {(k, n, m) for k, n, m, _ in surface(REF / "models" / "pretrain.py")}
    assert len(MODULES) == 58
