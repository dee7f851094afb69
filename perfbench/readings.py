"""Read the numbers that decide ``correct`` over many seeds in one process: sound
runs of the program as the configuration states it (the lower readings), and runs
of the lower-precision control, the program's own lower-precision rows (the
configuration's ``control``) judged against the reference of the stated precision
(the upper readings). The benchmark's own runs never run the control.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3 [--out chiprun_out/<file>.jsonl]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.lib.cell import load_benchmark, resolve  # noqa: E402
from perfbench.lib.runner import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    cell = resolve(load_benchmark(), args.workload)
    plan = [(int(s), None) for s in args.seeds.split(",") if s]
    plan += [(int(s), cell.config["control"]) for s in args.control_seeds.split(",") if s]
    for seed, variant in plan:
        out, checks = run(cell, seed, args.seconds, False, args.device, variant=variant)
        kind = "control" if variant else "sound"
        row = {"workload": args.workload, "seed": seed, "kind": kind, "correct": out["correct"],
               "answers": out["attempted"] - out["failed"],
               "checks": {k: v["value"] for k, v in checks.items()}}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
