"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root names the
cell's configuration and traffic mix; the configuration is the file its entry
names, the traffic mix ``traffic/<mix>.json``, the driver ``drivers/<driver>.py``
(the traffic file's ``driver``) and each per-layer metric ``metrics/<name>.py``.
Nothing here is specific to a cell, so a new cell, mix or metric is new files and
new entries.

The models a configuration runs are plug-ins found the same way. A configuration
file may hold ``"models": {"embedder": "<name>", "reranker": "<name>"}``; a role it
leaves out takes its default (``models/defaults.json``). Each name is two files:

* ``models/<name>.py``, the program side (``lib/system.py`` calls it): an optional
  ``place(inputs) -> dict`` of arrays the index state holds for the model, and, for
  an embedder, ``build(inputs, state)``, the query embedder handed to both entries.
  The program's entries take no reranker object: it builds its reranker from
  ``rerank_backend`` over what was placed. ``inputs`` is ``lib/system.Inputs``:
  the corpus, the configuration file, the program's ``RAGConfig``, the run's
  seed, the variant (a control) and the device. It builds through the program's public entries,
  imports the program inside its functions only, and may export ``OWN_KERNELS``
  (as ``lib/trace.OWN_KERNELS``), merged with the frozen table for its cells.
* ``reference/models/<name>.py``, the plain side (``reference/pipeline.py`` calls
  it): ``build(ref, seed)``, an object over the reference ``ref``. An embedder's
  gives ``vector(text, path) -> f32[D]`` and ``tokens(text, path) -> (f32[T, Dm],
  f32[T] weights)``; a reranker's ``scores(text, path, parents, rrf) -> f32[K]``
  over a query's K candidate parents and their fused scores. Plain PyTorch and
  NumPy: nothing of the program, nothing of JAX.

So a new configuration, with its models, is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Model:
    """One model plug-in of a configuration: its role, name and two sides."""

    role: str  # "embedder" or "reranker"
    name: str
    program: ModuleType  # models/<name>.py
    reference: ModuleType  # reference/models/<name>.py


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in ``workloads``
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    driver: ModuleType
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: Dict[str, Tuple[dict, ModuleType]]  # per-layer metric -> (entry, reader)
    models: Dict[str, Model]  # role -> the configuration's plug-in


def models(config: dict, root: Path = ROOT) -> Dict[str, Model]:
    """The plug-ins a configuration file names (the defaults where it names none),
    by role, from the benchmark's folder in the checkout at ``root``."""
    here = root / HERE.name
    with open(here / "models" / "defaults.json") as f:
        defaults = json.load(f)
    names = {**defaults, **config.get("models", {})}
    unknown = set(names) - set(defaults)
    if unknown:
        raise KeyError(f"no model role {sorted(unknown)} (have {sorted(defaults)})")
    return {
        role: Model(role, name,
                    load_module(here / "models" / f"{name}.py", f"perfbench_model_{name}"),
                    load_module(here / "reference" / "models" / f"{name}.py",
                                f"perfbench_reference_model_{name}"))
        for role, name in names.items()
    }


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files loaded, from the benchmark's
    folder in the checkout at ``root``."""
    here = root / HERE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    entry = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    driver = load_module(here / "drivers" / f"{traffic['driver']}.py",
                         f"perfbench_driver_{traffic['driver']}")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    readers = {
        m["name"]: (m, load_module(here / "metrics" / f"{m['name']}.py",
                                   "perfbench_metric_" + m["name"].replace(".", "_")))
        for m in bench["per_layer"] if reports(m, name) and m["moves"] in e2e_names
    }
    return Cell(name, entry, config, traffic, driver, e2e, readers, models(config, root))
