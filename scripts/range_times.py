"""Host and device milliseconds a unit by profiler range, for one benchmark cell.

    python3 scripts/range_times.py --workload rag1m-bf16.batch128 --seed 7 --units 12

builds the cell's inputs and system as ``perfbench/run.py`` does, warms up with
the cell's own warm-up, then runs ``--units`` units under ``torch.profiler`` with
the benchmark's spans. For every ``engine.*`` and ``bench.*`` range it prints how
often it opened, its host ms a unit (inclusive, and self: less the ranges opened
inside it), and for an ``engine.*`` range the device busy ms a unit inside its
device-side intervals (the benchmark's ``stage_s``); then the idle device ms a unit
by the chain of ranges open, as the benchmark's breakdown labels it. It needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_ranges(prof):
    """{name: [count, inclusive us, self us]} over the host-side ranges of the
    benchmark and the program, self time less the ranges nested inside."""
    from perfbench.lib.trace import RANGE_PREFIXES
    from torch.autograd import DeviceType

    by_thread = defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA or not ev.name().startswith(RANGE_PREFIXES):
            continue
        by_thread[ev.start_thread_id()].append((ev.start_ns(), ev.end_ns(), ev.name()))
    out = defaultdict(lambda: [0, 0.0, 0.0])
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack = []  # [end, name, us in ranges nested inside, start]
        for s, t, name in evs + [(float("inf"), float("inf"), "")]:
            while stack and stack[-1][0] <= s:
                end, n, child, start = stack.pop()
                out[n][2] += (end - start) / 1e3 - child
                if stack:
                    stack[-1][2] += (end - start) / 1e3
            if name:
                out[name][0] += 1
                out[name][1] += (t - s) / 1e3
                stack.append([t, name, 0.0, s])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.lib import trace as tr
    from perfbench.lib.cell import load_benchmark, resolve
    from perfbench.lib.generator import build_corpus, make_texts
    from perfbench.lib.runner import pin_cores, warm
    from perfbench.lib.system import build_system
    from perfbench.run import HOST_CORES

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = resolve(load_benchmark(), args.workload)
    corpus = build_corpus(cell.config["corpus"], args.seed, "cuda")
    texts, _ = make_texts(corpus, cell.traffic, args.seed)
    pin_cores(HOST_CORES)
    system = build_system(corpus, cell.config, "cuda")
    driver = cell.driver.Driver(system, cell.traffic)
    del system
    units = int(cell.traffic["warm_units"])
    warm(driver, texts[-(units + 1) * driver.width:], units)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        driver.step(texts[:driver.width])
    torch.cuda.synchronize()
    spans = tr.Spans(torch.cuda.synchronize)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with driver.traced(spans):
            t0 = time.perf_counter()
            for i in range(args.units):
                w = driver.width
                driver.step(texts[(i + 1) * w:(i + 2) * w])
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
    s = tr.summarize(prof, cell.driver.UNIT, args.units, args.units * driver.width, window,
                     spans.seconds, {})
    n = args.units
    print(f"{args.workload} on {torch.cuda.get_device_name(0)}: {n} units, window "
          f"{1e3 * window / n:.3f} ms a unit, device busy {1e3 * s.busy_s / n:.3f}")
    print(f"{'range':44s} {'count':>7s} {'host ms':>9s} {'self ms':>9s} {'device ms':>9s}")
    for name, (count, inc, own) in sorted(host_ranges(prof).items()):
        print(f"{name:44s} {count:7d} {inc / 1e3 / n:9.3f} {own / 1e3 / n:9.3f} "
              f"{1e3 * s.stage_s.get(name, 0.0) / n:9.3f}")
    for label, v in s.idle_s:
        print(f"idle {1e3 * v / n:9.3f} ms  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
