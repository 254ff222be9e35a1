#!/usr/bin/env python3
"""A benchmark cell's day by the program's spans, and what recording them
costs, on one card.

    python3 tools/span_probe.py --workload cics-paper.sweep880 \
        [--seed 3300000001] [--rounds 2]

Sets the cell up as ``cics_bench/run.py`` does (its fleets from the seed,
the burn-in, a one-day warm-up that builds the kernels), recorded
(``sim.profile_setup``: the set-up table, the burn-in's days and contracts,
the warm-up rollout's day, and each kernel's ``build`` span compiled or
found built), then:

1. the recording's cost: ``--rounds`` rounds of four rollouts of the
   cell's days from the burned-in state, in turns off, on, on, off
   (``repro_torch.spans.recording()`` around the "on" ones); each day's
   host ms between end-of-day hooks (the benchmark's ``day_host_ms``) and,
   on, the mean ``day`` span;
2. the stage table: one rollout recorded (``sim.stage_rows``: each span
   path's host and self ms a day, launches of kernels #1-#3) and one
   recorded under the profiler (``cics_bench/spans.py``'s ``attribute``
   by path: each span's device ms, kernel launches, the idle ms of the
   gaps its launches ended and the host's ms in synchronising calls, a
   day's mean, its child spans' included).

Prints the three, with the card's name and power limit, and writes them to
``chiprun_out/span_probe_<workload>.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3300000001)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from cics_bench import harness, spec
    from cics_bench import spans as bench_spans
    from cics_bench.traffic import generator
    from repro_torch import sim, spans
    from repro_torch.core import stages
    from repro_torch.sim import engine

    cell = spec.Cell(args.workload)
    dims = {k: cell.sim[k] for k in ("n_clusters", "n_campuses", "n_zones",
                                     "pds_per_cluster")}
    cfg = engine.SimConfig(**cell.sim)
    days = cell.days
    params = stages.SimParams(**generator.build_batch(
        cell.traffic, dims, args.seed, "cuda"))
    state, setup = sim.profile_setup(cfg, params, device="cuda")
    card = harness._power_limit()
    print(f"[setup] {args.workload} ({card}): the burn-in and a one-day "
          "warm-up, recorded", flush=True)
    print(sim.format_stage_table(setup), flush=True)

    # 1. the recording's cost, in turns
    gaps = []
    mark = [0.0]

    def on_day(d, st, out):
        now = time.perf_counter()
        if d >= 0:
            gaps.append(now - mark[0])
        mark[0] = time.perf_counter()

    roll = engine.make_rollout(cfg, days, on_day=on_day)
    runs = []
    for _ in range(args.rounds):
        for on in (False, True, True, False):
            gaps.clear()
            if on:
                with spans.recording() as rec:
                    roll(params, state)
                day_ms = [s.host_ns * 1e-6 for s in rec.spans
                          if s.name == "day"]
            else:
                roll(params, state)
                day_ms = []
            torch.cuda.synchronize()
            runs.append({"on": on,
                         "day_host_ms": 1e3 * statistics.fmean(gaps),
                         "day_span_ms": statistics.fmean(day_ms)
                         if day_ms else None})
    off = [r["day_host_ms"] for r in runs if not r["on"]]
    on = [r["day_host_ms"] for r in runs if r["on"]]
    span_ms = [r["day_span_ms"] for r in runs if r["on"]]
    cost = {"runs": runs, "off_median": statistics.median(off),
            "on_median": statistics.median(on),
            "on_cost_ms": statistics.median(on) - statistics.median(off),
            "day_span_median": statistics.median(span_ms)}
    print(f"[cost] {args.workload} ({card}): day_host_ms off {off}, on {on}"
          f"; the day span on {span_ms}; on - off (medians) "
          f"{cost['on_cost_ms']:+.3f} ms a day", flush=True)

    # 2. the stage table: host from one recorded rollout, device from one
    # recorded under the profiler
    plain = engine.make_rollout(cfg, days)
    torch.cuda.synchronize()
    with spans.recording() as rec:
        plain(params, state)
    torch.cuda.synchronize()
    rows = sim.stage_rows(rec)
    with spans.recording():
        events = bench_spans._profiled(lambda: plain(params, state), True)
    device = bench_spans.attribute(events, paths=True)
    for r in rows:
        for k in ("calls", "rounds", "steps"):
            r[k] = round(r[k] / days)
        for k in ("host_ms", "self_ms"):
            r[k] /= days
        r["launches"] = tuple(round(x / days) for x in r["launches"])
        r["sizes"] = {k: sorted({json.dumps(v, sort_keys=True)
                                 for v in vs})
                      for k, vs in r["sizes"].items()}
        got = device.get("rollout/" + r["path"])
        if got is not None:
            r["device_ms"] = got["busy_ms"] / days
            r["device_launches"] = round(got["launches"] / days)
            r["idle_ms"] = got["idle_ms"] / days
            r["wait_ms"] = got["wait_ms"] / days
    print(f"[stages] {args.workload} ({card}): a day's mean over {days} "
          "days", flush=True)
    print(sim.format_stage_table(rows), flush=True)
    print(f"[stages] {args.workload}: device ms, kernels, the idle ms they "
          "ended and the host's ms in synchronising calls, a day's mean, "
          "child spans included", flush=True)
    for r in rows:
        if "device_ms" in r:
            print(f"  {r['path']:<40} {r['device_ms']:9.2f} "
                  f"{r['device_launches']:7d} {r['idle_ms']:9.2f} "
                  f"{r['wait_ms']:9.2f}", flush=True)
    own = bench_spans.attribute(events)
    print("[stages] device ms a day by innermost span: "
          + ", ".join(f"{k} {v['busy_ms'] / days:.2f}"
                      for k, v in sorted(own.items(),
                                         key=lambda kv: -kv[1]["busy_ms"])),
          flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"span_probe_{args.workload}.json").write_text(json.dumps(
        {"workload": args.workload, "seed": args.seed, "card": card,
         "cost": cost, "setup": setup, "rows": rows,
         "device_innermost": {k: {kk: vv / days for kk, vv in v.items()}
                              for k, v in own.items()}}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
