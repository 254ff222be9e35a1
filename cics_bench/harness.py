"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result line.

Set-up builds the cell's fleets from the seed (``traffic.generator``),
burns them in through the program's ``sim.engine.make_init`` and warms up
with a one-day rollout at the cell's shapes, which builds the program's
kernels (their cache is ``build/`` in the checkout). The window then
drives the program's ``make_rollout`` over and over from the burned-in
state until ``seconds`` have passed on the host's clock; a CUDA event on
the stream marks the end of every day, the same hook keeps the day's
record of the sampled fleets (``check.record``, a few row copies on the
device), and the host synchronises only when the window has closed. The
end-to-end metrics are read from those events by their readers
(``metrics/``), as the per-layer ones are.

With a trace, one more rollout runs under the profiler (``trace``) with
the program's kernel launches recorded (``costs``); a per-layer metric
whose module has a ``measure(ctx)`` then takes its own reading
(``Context``), and the per-layer metrics are read by their readers
(``metrics/``). Then the program's state is freed and the reference
follows the last rollout's recorded days from the program's own states
(``check``).
"""
from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import time
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class HostEvent:
    """A CUDA event's interface on the host's clock, for a run on the CPU
    (the tests)."""

    def __init__(self, **_):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class Run:
    """What the metric readers read: the measured window's day ends
    (``window``), the benchmark's spans (``spans``: ``setup`` and
    ``burn_in`` in seconds; ``day_host`` and ``day_host_cpu``, each day's
    wall and thread CPU seconds on the host), what metrics measured
    themselves (``measured``, by metric name), the trace, the recorded
    kernel launches and the reference's halvings tally."""

    def __init__(self):
        self.spans: Dict = {}
        self.measured: Dict[str, float] = {}
        self.trace = None
        self.launches: Dict[str, List[Dict]] = {}
        self.tally = None
        self.days_traced = 0
        self.window: Dict = {}


class Context:
    """What a metric's ``measure(ctx)`` gets after the traced window: the
    cell, the program's ``SimConfig``, its parameters and burned-in state,
    and ``best_of``, which times a call on the device's events."""

    def __init__(self, cell, cfg, params, state, device: str):
        self.cell, self.cfg, self.params, self.state = (cell, cfg, params,
                                                        state)
        self.device = device

    def best_of(self, fn, reps: int = 5) -> float:
        """The fastest of ``reps`` calls of ``fn`` after one more, in ms
        between events around each call."""
        import torch
        on_card = self.device == "cuda"
        Event = torch.cuda.Event if on_card else HostEvent
        fn()
        best = float("inf")
        for _ in range(reps):
            if on_card:
                torch.cuda.synchronize()
            a, b = Event(enable_timing=True), Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            if on_card:
                torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
        return best


def _tree_rows(tree, index):
    """The rows ``index`` of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: _tree_rows(v, index) for k, v in tree.items()}
    return tree.index_select(0, index)


def tree_to(tree, device):
    """Every tensor of a nested dict on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class LaunchRecorder:
    """Wraps the program's kernel entry points named by the cost modules
    and records each outermost launch's sizes, by cost name."""

    def __init__(self, cost_modules):
        self.costs = cost_modules
        self.saved = []
        self.launches: Dict[str, List[Dict]] = {c.NAME: [] for c in
                                                cost_modules}
        self.depth = 0

    def __enter__(self):
        for c in self.costs:
            mod = importlib.import_module(c.TARGET[0])
            fn = getattr(mod, c.TARGET[1])
            self.saved.append((mod, c.TARGET[1], fn))
            setattr(mod, c.TARGET[1], self._wrap(c, fn))
        return self

    def _wrap(self, cost, fn):
        def wrapped(*args, **kwargs):
            outer = self.depth == 0
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                if outer:
                    self.launches[cost.NAME].append(cost.shape(args, kwargs))
        for k, v in vars(fn).items():
            setattr(wrapped, k, v)
        return wrapped

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        return False


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def sample_of(cell, seed: int) -> List[int]:
    from cics_bench import check
    return check.sample_fleets(len(cell.traffic["scenarios"]),
                               int(cell.traffic["seeds_per_scenario"]), seed,
                               cell.sample_per_scenario)


def reference_program(cell, fields, sample, lower=None) -> Dict:
    """The reference in the program's place: its burn-in and rollout of
    the sampled fleets, recorded as the program's are (``check.record``);
    ``lower`` rounds it as the control does."""
    import torch

    from cics_bench import check
    from cics_bench.reference import day as rday
    index = torch.as_tensor(sample, device=fields["key"].device)
    params = _tree_rows(fields, index)
    kw = {} if lower is None else {"lower": lower}
    st = rday.burn_in(cell.sim, params, **kw)
    start, steps = dict(st), []
    for d in range(cell.days):
        probe: Dict = {}
        st, res, cf = rday.day_step(cell.sim, params, st,
                                    rday.day_xs(params, d), probe=probe,
                                    **kw)
        steps.append(check.record(st, res, cf, probe["vcc_curve"],
                                  probe["shaped"], probe["prob"],
                                  probe.get("take")))
    return {"start": start, "steps": steps, "final": st,
            "ledger": check.ledger(steps)}


def program_record(state, out) -> Dict:
    """``check.record`` of a program's day: its state after the day and
    its ``StepOut``."""
    from cics_bench import check
    take = None if out.best is None else out.best.take
    return check.record(state, out.res, out.cf, out.vcc_curve,
                        out.sol.shaped, out.prob, take)


def judge_rollout(cell, fields, sample, prog: Dict, tally=None,
                  fleet_days: bool = False) -> Dict:
    """The reference's burn-in and its steps from the rollout's own states
    (``check.follow``), compared (``check.compare``): the numbers and
    their detail."""
    import torch

    from cics_bench import check
    from cics_bench.reference import day as rday
    dev = fields["key"].device
    index = torch.as_tensor(sample, device=dev)
    params = _tree_rows(fields, index)
    start = tree_to(prog["start"], dev)
    steps = [tree_to(s, dev) for s in prog["steps"]]
    ref_start = check.host(rday.burn_in(cell.sim, params))
    followed = check.follow(cell.sim, params, start, steps, tally)
    mine = {"start": check.host(prog["start"]),
            "steps": [check.host(s) for s in prog["steps"]],
            "final": check.host(prog["final"]),
            "ledger": check.host(prog["ledger"])}
    return check.compare(mine, ref_start, followed, fleet_days)


def _traced(cell, cfg, params, state, log: Run, device: str):
    """One more rollout under the profiler with the kernel launches that
    the per-layer metrics' cost modules name recorded; then each per-layer
    metric with a ``measure`` takes its reading."""
    from cics_bench import spec
    from cics_bench import trace as _trace
    from repro_torch.sim import engine
    mods = {m["name"]: spec.module(m["name"]) for m in cell.per_layer}
    costs = {c.NAME: c for c in (getattr(mod, "COST", None)
                                 for mod in mods.values()) if c is not None}
    roll = engine.make_rollout(cfg, cell.days)
    with LaunchRecorder(costs.values()) as rec:
        _, log.trace = _trace.record(lambda: roll(params, state), device)
    log.launches = rec.launches
    log.days_traced = cell.days
    ctx = Context(cell, cfg, params, state, device)
    for name, mod in mods.items():
        if hasattr(mod, "measure"):
            log.measured[name] = mod.measure(ctx)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> Dict:
    """Run ``cell`` once on ``device`` ("cpu" for the tests: no kernel, so
    no warm-up); returns the result dict (its ``check`` last)."""
    import torch

    from cics_bench import check, spec
    from cics_bench.reference import solve as rsolve
    from cics_bench.traffic import generator
    from repro_torch.core import stages
    from repro_torch.sim import engine

    on_card = device == "cuda"
    Event = torch.cuda.Event if on_card else HostEvent

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sim = cell.sim
    dims = {k: sim[k] for k in ("n_clusters", "n_campuses", "n_zones",
                                "pds_per_cluster")}
    cfg = engine.SimConfig(**sim)
    days = cell.days
    log = Run()

    # ---- set-up
    fields = generator.build_batch(cell.traffic, dims, seed, device)
    params = stages.SimParams(**fields)
    B = int(params.key.shape[0])
    sync()
    t0 = time.perf_counter()
    state = engine.make_init(cfg, device=device)(params)
    sync()
    log.spans["burn_in"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if on_card:
        engine.make_rollout(cfg, 1)(params, state)
        sync()
    warmup_s = time.perf_counter() - t0

    # ---- the measured window
    sample = sample_of(cell, seed)
    index = torch.as_tensor(sample, device=params.key.device)
    steps: List[Dict] = []
    ends: List = []
    host_days: List[float] = []
    host_cpu: List[float] = []
    mark = [0.0, 0.0]

    def on_day(d, st, out):
        now, cpu = time.perf_counter(), time.thread_time()
        if d >= 0:
            ev = Event(enable_timing=True)
            ev.record()
            ends.append(ev)
            host_days.append(now - mark[0])
            host_cpu.append(cpu - mark[1])
            steps.append(check.pick(program_record(st, out), index))
        else:
            steps.clear()
        mark[0], mark[1] = time.perf_counter(), time.thread_time()

    roll = engine.make_rollout(cfg, days, on_day=on_day)
    sync()
    start = Event(enable_timing=True)
    start.record()
    w0 = time.perf_counter()
    setup = w0 - t_start
    out = None
    while time.perf_counter() - w0 < seconds:
        out = roll(params, state)
    sync()
    stamps = [start.elapsed_time(e) for e in ends]
    inside = [t for t in stamps if t <= seconds * 1e3]
    fleet_days = B * len(inside)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log.spans["day_host"] = host_days
    log.spans["day_host_cpu"] = host_cpu
    log.spans["setup"] = setup
    log.window = {"seconds": seconds, "batch": B, "ends_ms": inside}

    metrics: Dict[str, Dict] = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu", "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    breakdown = None

    # ---- the traced window
    if trace:
        _traced(cell, cfg, params, state, log, device)
        device_info["busy_s"] = log.trace.busy_s
        device_info["window_s"] = log.trace.window_s
        breakdown = log.trace.breakdown()

    # ---- the check: the reference follows the last rollout's days
    prog = None
    if out is not None:
        prog = {"start": check.pick(check.state_fields(state), index),
                "steps": list(steps),
                "final": check.pick(check.state_fields(out[0]), index),
                "ledger": check.pick(check.ledger_fields(out[1]), index)}
    del out, state, params, roll, steps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log.tally = rsolve.Tally() if trace else None
    detail = {}
    if prog is not None:
        judged = judge_rollout(cell, fields, sample, prog, log.tally)
        nums, detail = judged["numbers"], judged["detail"]
        correct, lines = check.judge(nums, cell.limits)
    else:
        nums, correct, lines = {}, False, ["no rollout finished"]
    sync()
    ref_s = time.perf_counter() - t0

    # ---- the result
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(log)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"seed": seed, "batch": B, "days_in_window": len(inside),
            "rollouts": len(ends) // days, "warmup_s": warmup_s,
            "burn_in": log.spans["burn_in"], "reference_s": ref_s,
            "sample": sample, "check_detail": detail}
    if on_card:
        device_info["power"] = _power_limit()
    result = {"correct": bool(correct), "attempted": int(fleet_days),
              "failed": 0 if correct else int(fleet_days),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = info
    info["unlimited"] = {k: nums.get(k) for k in check.NUMBERS
                         if k not in cell.limits}
    result["check"] = {k: {"value": nums.get(k), "limit": cell.limits[k]}
                       for k in check.NUMBERS if k in cell.limits}
    result["_lines"] = lines
    return result


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from cics_bench import spec
    cell = spec.Cell(args.workload)
    try:
        import torch
    except ImportError as e:
        print(f"cics_bench: torch is missing ({e})", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cics_bench: the cell needs {cell.chips} CUDA card(s); torch "
              f"sees {seen}. No result.", file=sys.stderr)
        return 2
    try:
        importlib.import_module("repro_torch.sim.engine")
    except ImportError as e:
        print(f"cics_bench: the program is missing ({e}). No result.",
              file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"cics_bench: the run loaded {', '.join(bad)}. No result.",
              file=sys.stderr)
        return 4
    lines = result.pop("_lines")
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
