"""Nothing the benchmark runs loads JAX or the JAX package, judged by whole
top-level module names (``triple_hybrid_rag_tpu_torch`` is another name, not a
prefix match), and the reference, its model plug-ins included, loads nothing of
the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from perfbench.lib.cell import HERE, ROOT
from perfbench.lib.runner import FORBIDDEN, forbidden_modules

PROGRAM = "triple_hybrid_rag_tpu_torch"


def top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    plugins = ", ".join(f"perfbench.reference.models.{p.stem}"
                        for p in sorted((HERE / "reference" / "models").glob("[!_]*.py")))
    mods = top_levels("import perfbench.reference.pipeline, perfbench.reference.judge, " + plugins)
    assert not mods & set(FORBIDDEN) and PROGRAM not in mods


def test_harness_and_program_load_no_jax():
    mods = top_levels(
        "import perfbench.lib.runner, perfbench.lib.system, perfbench.lib.trace\n"
        "import triple_hybrid_rag_tpu_torch.engine, triple_hybrid_rag_tpu_torch.retrieval\n"
        "from perfbench.lib.cell import load_benchmark, resolve\n"
        "[resolve(load_benchmark(), w['name']) for w in load_benchmark()['workloads']]\n")
    assert PROGRAM in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_whole_name_check():
    import triple_hybrid_rag_tpu_torch  # noqa: F401

    assert PROGRAM in {m.split(".")[0] for m in sys.modules}
    assert PROGRAM not in forbidden_modules()


def test_no_source_imports_jax():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
        if "reference" in path.relative_to(HERE).parts:
            assert PROGRAM not in path.read_text().replace(f"``{PROGRAM}", ""), path


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "rag1m-int8.staged",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        return  # on a card this is a real run; the card tests cover it
    assert out.returncode != 0 and out.stdout.strip() == ""
