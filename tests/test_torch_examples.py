"""The port's examples against the reference's, each in a process of its own.

``examples/torch_basic_usage.py`` and ``examples/torch_production_serving.py`` run
with ``--device cpu`` in processes where importing JAX, flax, optax or the JAX
package raises; ``examples/basic_usage.py`` and ``examples/production_serving.py``
run with ``JAX_PLATFORMS=cpu`` on one device, their fixed ``/tmp`` index path
redirected into a temporary directory. The four processes run at once. Every
answer line the reference prints must come out of the port the same: the
refusals and their reasons, the top texts and channels, the graph API's answers,
the corpus stats, the ``/rerank`` winner and the migrated checkpoint's answer.
Timings are masked; scores, printed rounded to 3 (``/rerank``: 2) decimals, may
differ by one printed step, which is what a difference under 1e-3 (1e-2) can
show after rounding. Without a card and without ``--device cpu`` an example
stops with the port's error instead of running on the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "triple_hybrid_rag_tpu")
PAIRS = {"basic": ("basic_usage.py", "torch_basic_usage.py"),
         "serving": ("production_serving.py", "torch_production_serving.py")}
# the reference's basic example saves to a fixed path; the child redirects it
REF_RUNNER = r"""
import runpy, sys, tempfile
from triple_hybrid_rag_tpu import facade
tmp = tempfile.mkdtemp()
save, load = facade.RAG.save, facade.RAG.load.__func__
fix = lambda d: tmp + "/index" if str(d) == "/tmp/thr_example_index" else d
facade.RAG.save = lambda self, d, *a, **k: save(self, fix(d), *a, **k)
facade.RAG.load = classmethod(lambda cls, d, *a, **k: load(cls, fix(d), *a, **k))
sys.argv = [sys.argv[1]]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
PORT_ONLY = ("jax loaded:", "kernel launches:", "cross-tenant top ->")
TIMING = [(re.compile(r"\(\d+\.\d+ ms\)"), "(ms)"), (re.compile(r"total \d+\.\d+ ms"), "total ms")]
SCORE = re.compile(r"\[(\d+\.\d{3})\]|score (\d+\.\d{2})\)")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", **extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference's stdout, port's stdout)}, the four processes run at once."""
    poison = tmp_path_factory.mktemp("poison")
    for name in FORBIDDEN:
        (poison / name).mkdir()
        (poison / name / "__init__.py").write_text(f"raise ImportError('{name} imported')\n")
    procs = {}
    for name, (ref, port) in PAIRS.items():
        cwd = tmp_path_factory.mktemp(name)
        procs[name] = (
            subprocess.Popen([sys.executable, "-c", REF_RUNNER, str(EXAMPLES / ref)], cwd=cwd,
                             env=_env(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu"),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            subprocess.Popen([sys.executable, str(EXAMPLES / port), "--device", "cpu"], cwd=cwd,
                             env=_env(PYTHONPATH=str(poison)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        )
    out = {}
    for name, pair in procs.items():
        texts = []
        for p in pair:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-3000:]
            texts.append(stdout)
        out[name] = tuple(texts)
    return out


def _answers(text: str):
    """(lines with timings and scores masked, the scores) of the lines both
    examples print."""
    lines, scores = [], []
    for line in text.splitlines():
        if not line.strip() or line.startswith(PORT_ONLY):
            continue
        for pattern, mask in TIMING:
            line = pattern.sub(mask, line)
        for m in SCORE.finditer(line):
            scores.append((float(m.group(1) or m.group(2)), 1e-3 if m.group(1) else 1e-2))
        lines.append(SCORE.sub("<score>", line))
    return lines, scores


def _same_answers(ref: str, port: str):
    (ref_lines, ref_scores), (port_lines, port_scores) = _answers(ref), _answers(port)
    assert port_lines == ref_lines
    assert len(port_scores) == len(ref_scores)
    for (a, step), (b, _) in zip(port_scores, ref_scores):
        assert abs(a - b) <= step * (1 + 1e-6), (a, b)


def _port_tail(port: str):
    tail = dict(line.split(": ", 1) for line in port.splitlines() if line.startswith(PORT_ONLY[:2]))
    assert tail["jax loaded"] == "False"
    return tail


def test_basic_example_answers_as_the_reference(runs):
    ref, port = runs["basic"]
    _same_answers(ref, port)
    assert "REFUSED: Max score" in port and "Q: completely unrelated gibberish zzz" in port
    assert "restored corpus:" in port
    # the launch counts stay 0 on the CPU (a CPU tensor runs the plain versions)
    assert _port_tail(port)["kernel launches"] == '{"dense_scores": 0, "maxsim": 0}'


def test_serving_example_answers_as_the_reference(runs):
    ref, port = runs["serving"]
    _same_answers(ref, port)
    assert "HTTP /rerank -> winner index 1 (maxsim" in port
    assert "migrated int8 checkpoint answers: refused=False, top='# Billing policy'" in port
    # tenant_b's collection answers with tenant_b's text only
    assert "cross-tenant top -> # Shipping" in port
    assert _port_tail(port)["kernel launches"] == '{"bucket_maxima": 0, "maxsim": 0}'


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_example_without_a_card_stops(name, tmp_path):
    """No CUDA and no ``--device cpu``: the port's error, no silent CPU run."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is present: the example would run on it")
    out = subprocess.run([sys.executable, str(EXAMPLES / PAIRS[name][1])], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available; pass device='cpu'" in out.stderr
    assert "Q:" not in out.stdout and "batched" not in out.stdout
