"""Scenario sweep: the whole library x seeds in ONE batch.

Runs >= 8 scenarios x 4 seeds of multi-week CICS rollouts in a single
batched call (burn-in, then the days, each day one step over the whole
scenario-seed axis), then prints the per-scenario table of carbon saved vs.
the unshaped counterfactual, peak-power reduction, and flexible-work
completion within 24h. The PyTorch counterpart of
``examples/scenario_sweep.py``; it runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples_torch/scenario_sweep.py [--days 14]
        [--seeds 4] [--sharded] [--device cuda]

``--sharded`` runs the same batch through `rollout_batch_sharded`: the
(scenario x seed) axis is split over every card (over the one device
``--device`` names otherwise); the results are bit for bit
`rollout_batch`'s, so the table does not change, only the wall clock on
multi-card hosts.

Reading the table: carbon-priced scenarios trade peak power for carbon
(negative peakRed% — the 'War of the Efficiencies'); `peak_shaver` flips
the prices and the sign.

``--risk`` swaps in the risk-sweep family (`risk_sweep_library`): CVaR
tail fraction beta in {0.5, 0.9, 0.99} under drought + surge, run once
per ensemble size K in RISK_MEMBERS = {1, 8, 32}. K=1 is the degenerate
control: every beta row is identical to the point-forecast path.

``--spatial`` swaps in the mobility-sweep family
(`mobility_sweep_library`): spatial mobility in {0, 10, 30, 60}% under a
zone-0 renewable drought + demand surge, run TWICE over the same batch —
once with the joint spatio-temporal optimizer
(`SimConfig(joint_spatial=True)`) and once with the sequential greedy
pre-shift. The vsSeq% column is the carbon the joint optimizer saves over
the sequential two-phase baseline; mobility=0 is the temporal-only
control row.

``--telemetry`` reruns the default library with the DayTelemetry record
stacked into the rollout (`SimConfig(telemetry=True)`) and prints a
second table of solver convergence and forecast calibration per scenario;
``--trace PATH`` additionally exports the raw per scenario x seed x day
records as JSONL.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.sim import (MOBILITY_COLUMNS, RISK_COLUMNS,  # noqa: E402
                             RISK_MEMBERS, SimConfig, TELEMETRY_COLUMNS,
                             build_batch, default_library, format_table,
                             mobility_sweep_library, mobility_sweep_rows,
                             risk_sweep_library, risk_sweep_rows,
                             rollout_batch, rollout_batch_sharded,
                             scenario_rows, telemetry_records,
                             telemetry_rows, write_jsonl)


def _engine(args, cfg, days):
    """The batch's run function: ``rollout_batch`` on ``args.device``, or
    with ``--sharded`` ``rollout_batch_sharded`` over every card (over
    ``args.device`` alone when it is not ``cuda``)."""
    if not args.sharded:
        return rollout_batch(cfg, days, device=args.device)
    devices = None if args.device == "cuda" else (args.device,)
    return rollout_batch_sharded(cfg, days, devices=devices)


def _timed(args, run, batch):
    """``run(batch)`` and its wall seconds, ended by a synchronize on the
    card."""
    t0 = time.time()
    out = run(batch)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    return out, time.time() - t0


def run_risk_sweep(args):
    scenarios = risk_sweep_library(args.days)
    seeds = list(range(args.seeds))
    ledgers_by_k = {}
    for k in RISK_MEMBERS:
        cfg = SimConfig(n_clusters=args.clusters, n_campuses=4, n_zones=4,
                        pds_per_cluster=2, hist_days=args.hist,
                        n_members=k)
        batch = build_batch(cfg, scenarios, seeds, args.days,
                            device=args.device)
        (_, led, _), wall = _timed(args, _engine(args, cfg, args.days),
                                   batch)
        print(f"K={k}: {len(scenarios) * len(seeds)} rollouts in "
              f"{wall:.1f}s wall")
        ledgers_by_k[k] = led
    rows = risk_sweep_rows(ledgers_by_k, [s.name for s in scenarios],
                           len(seeds))
    for r in rows:
        r["scenario"] = f"K={r['n_members']:<3d} {r['scenario']}"
    print()
    print(format_table(rows, RISK_COLUMNS))
    print("\n(risk_beta = averaged worst-tail fraction: smaller = more "
          "risk-averse; K=1 rows are the degenerate point-forecast "
          "control)")
    return {"rows": rows}


def run_mobility_sweep(args):
    scenarios = mobility_sweep_library(args.days)
    seeds = list(range(args.seeds))
    ledgers = {}
    for joint in (True, False):
        cfg = SimConfig(n_clusters=args.clusters, n_campuses=4, n_zones=4,
                        pds_per_cluster=2, hist_days=args.hist,
                        joint_spatial=joint)
        batch = build_batch(cfg, scenarios, seeds, args.days,
                            device=args.device)
        (_, led, _), wall = _timed(args, _engine(args, cfg, args.days),
                                   batch)
        mode = "joint" if joint else "sequential"
        print(f"{mode}: {len(scenarios) * len(seeds)} rollouts in "
              f"{wall:.1f}s wall")
        ledgers[joint] = led
    rows = mobility_sweep_rows(ledgers[True], ledgers[False],
                               [s.name for s in scenarios], len(seeds))
    print()
    print(format_table(rows, MOBILITY_COLUMNS))
    print("\n(vsSeq% = carbon the joint spatio-temporal optimizer saves "
          "over the sequential greedy pre-shift on the same rollouts; "
          "mobility000 is the temporal-only control)")
    return {"rows": rows}


def main(argv=None):
    """Run the chosen sweep and print its tables. Returns ``{"rows":
    [...]}`` (the printed table's rows); the default library adds
    ``"wall_s"`` and, with ``--telemetry``, ``"telemetry_rows"`` and
    ``"records"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=14)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--hist", type=int, default=28)
    ap.add_argument("--sharded", action="store_true",
                    help="split the (scenario x seed) batch over every "
                         "card (bitwise-identical results)")
    ap.add_argument("--risk", action="store_true",
                    help="run the CVaR risk-sweep family (beta x K) "
                         "instead of the default library")
    ap.add_argument("--spatial", action="store_true",
                    help="run the mobility-sweep family through the joint "
                         "spatio-temporal optimizer vs the sequential "
                         "pre-shift")
    ap.add_argument("--telemetry", action="store_true",
                    help="stack the DayTelemetry record per day "
                         "(SimConfig(telemetry=True)) and print the "
                         "per-scenario solver/forecast diagnostics table")
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="with --telemetry: also write the per scenario x "
                         "seed x day trace records to PATH as JSONL")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.days < 1 or args.seeds < 1:
        ap.error("--days and --seeds must be >= 1")
    if args.risk and args.spatial:
        ap.error("--risk and --spatial are mutually exclusive")
    if args.trace and not args.telemetry:
        ap.error("--trace requires --telemetry")
    if args.telemetry and (args.risk or args.spatial):
        ap.error("--telemetry applies to the default scenario library")
    device_mod.resolve(args.device)
    if args.risk:
        return run_risk_sweep(args)
    if args.spatial:
        return run_mobility_sweep(args)

    cfg = SimConfig(n_clusters=args.clusters, n_campuses=4, n_zones=4,
                    pds_per_cluster=2, hist_days=args.hist,
                    telemetry=args.telemetry)
    scenarios = default_library(args.days)
    seeds = list(range(args.seeds))
    n_devices = torch.cuda.device_count() if args.device == "cuda" else 1
    mode = (f"split over {n_devices} device(s)"
            if args.sharded else "one batch")
    print(f"{len(scenarios)} scenarios x {len(seeds)} seeds x "
          f"{args.days} days ({cfg.n_clusters} clusters, "
          f"{cfg.hist_days}-day burn-in) in {mode}...")

    batch = build_batch(cfg, scenarios, seeds, args.days,
                        device=args.device)
    (_, ledgers, traj), wall = _timed(args, _engine(args, cfg, args.days),
                                      batch)
    n_rollouts = len(scenarios) * len(seeds)
    print(f"{n_rollouts} rollouts ({n_rollouts * args.days} fleet-days) "
          f"in {wall:.1f}s wall\n")

    rows = scenario_rows(ledgers, [s.name for s in scenarios], len(seeds))
    print(format_table(rows))
    print("\n(+carbonSaved% = shaped fleet emitted less than the unshaped "
          "counterfactual; flex<24h% = flexible work completed within a "
          "day, paper SLO)")
    out = {"rows": rows, "wall_s": wall}

    if args.telemetry:
        records = telemetry_records(traj["telemetry"],
                                    [s.name for s in scenarios], len(seeds))
        out["telemetry_rows"] = telemetry_rows(records)
        out["records"] = records
        print()
        print(format_table(out["telemetry_rows"], TELEMETRY_COLUMNS))
        print("\n(objDec% = PGD objective decrease across the dual-ascent "
              "rounds; thetaCov/uifQCov = forecast-bound coverage of the "
              "realized day; vccBind = fraction of hours admission is "
              "pinned at the VCC; queueAge = backlog in days of service)")
        if args.trace:
            write_jsonl(args.trace, records)
            print(f"\n{len(records)} trace records "
                  f"(scenario x seed x day) -> {args.trace}")
    return out


if __name__ == "__main__":
    main()
