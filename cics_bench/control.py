"""The readings that the limits of ``correct`` are set from, in one
process on the card, at a cell's own size:

* the program: for each seed, the cell's fleets burned in and one rollout
  of its days planned (no measured window), its days on the sample a run
  takes recorded and held against the reference (``harness.judge_rollout``):
  the sound runs' numbers;
* the control: the reference with its day problems and states stored in
  bfloat16 (``reference.day.lower_to``), the nearest precision below the
  configuration's float32, in the program's place (``harness.
  reference_program``), on ``--control-seeds``;
* the witness: the same float32 reference run on the host's CPU in the
  program's place, on ``--witness-seeds``: how far two sound float32
  computations of the same days lie apart, the SLO gates that rounding
  alone flips among them.

    python3 cics_bench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --witness-seeds 1 [--out <jsonl>]

Each reading is a JSON line (also appended to ``--out``).
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv):
    import argparse

    import torch

    from cics_bench import check, harness, spec
    from cics_bench.reference import day as rday
    from cics_bench.traffic import generator
    from repro_torch.core import stages
    from repro_torch.sim import engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    dev = "cuda"
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2

    def sync():
        torch.cuda.synchronize()

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def judge(side, seed, prog, fields, sample, side_s):
        t0 = time.perf_counter()
        judged = harness.judge_rollout(cell, fields, sample, prog,
                                       fleet_days=True)
        sync()
        emit({"cell": cell.name, "side": side, "seed": seed,
              "numbers": judged["numbers"], "detail": judged["detail"],
              "side_s": side_s, "reference_s": time.perf_counter() - t0})

    sim = cell.sim
    dims = {k: sim[k] for k in ("n_clusters", "n_campuses", "n_zones",
                                "pds_per_cluster")}
    cfg = engine.SimConfig(**sim)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    wseeds = [int(s) for s in args.witness_seeds.split(",") if s]
    order = seeds + cseeds + wseeds
    for seed in sorted(set(order), key=order.index):
        fields = generator.build_batch(cell.traffic, dims, seed, dev)
        sample = harness.sample_of(cell, seed)
        index = torch.as_tensor(sample, device=dev)
        if seed in seeds:
            params = stages.SimParams(**fields)
            steps = []

            def on_day(d, st, out):
                if d >= 0:
                    steps.append(check.pick(
                        harness.program_record(st, out), index))
            t0 = time.perf_counter()
            state = engine.make_init(cfg, device=dev)(params)
            out = engine.make_rollout(cfg, cell.days, on_day=on_day)(
                params, state)
            sync()
            prog_s = time.perf_counter() - t0
            prog = {"start": check.pick(check.state_fields(state), index),
                    "steps": steps,
                    "final": check.pick(check.state_fields(out[0]), index),
                    "ledger": check.pick(check.ledger_fields(out[1]), index)}
            del state, out, params
            judge("program", seed, prog, fields, sample, prog_s)
        if seed in cseeds:
            t0 = time.perf_counter()
            low = harness.reference_program(
                cell, fields, sample, lower=rday.lower_to(torch.bfloat16))
            sync()
            judge("control_bf16", seed, low, fields, sample,
                  time.perf_counter() - t0)
        if seed in wseeds:
            t0 = time.perf_counter()
            mine = harness.reference_program(
                cell, harness.tree_to(fields, "cpu"), sample)
            judge("witness_cpu", seed, mine, fields, sample,
                  time.perf_counter() - t0)
        del fields
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
