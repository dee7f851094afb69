"""Run one cell of the benchmark on the card and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; ``lib/cell.py`` finds its configuration, traffic mix, driver and
per-layer readers by name. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit); the
numbers compared are also the last lines of standard error. Without a CUDA card
(or with fewer than the cell asks for), without the program beside the benchmark,
or with JAX loaded once the window has closed, it exits non-zero and prints no
result. Build and kernel caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"  # keeps transformers, if anything loads it, off JAX
os.environ["USE_TF"] = "0"
HOST_CORES = 4  # the run keeps to this many cores once its inputs are made
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_CORES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.lib.cell import load_benchmark, resolve
    from perfbench.lib.runner import forbidden_modules, log, process_start, run

    t_start = process_start()
    bench = load_benchmark()
    cell = resolve(bench, args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import triple_hybrid_rag_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as err:
        log(f"the program is not beside the benchmark: {err}")
        return 3
    out, checks = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start,
                      cores=HOST_CORES)
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded in this process: {bad}")
        return 4
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
