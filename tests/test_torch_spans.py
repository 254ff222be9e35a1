"""The program's spans and counters (``repro_torch.spans``) and the
benchmark's reading of them (``cics_bench/spans.py``), on the CPU.

- A day of the paper, risk-aware joint and closed-loop configurations
  records the span tree the stages, solvers and rounds name, with each
  round's inner steps counted, and the burn-in its own; a day's children
  never overlap and its self time plus theirs is its time.
- Off (the default), a span is one shared no-op: no record, no clock read,
  no profiler range, even with the profiler on.
- A rollout recorded equals the same rollout not recorded, bit for bit.
- The stage rows are span paths: a closed-loop day's two kinds of rounds
  are two rows; the set-up rows hold the burn-in and a warm-up day; a
  kernel build counts compiled or found built.
- On under the profiler, the spans are ``cics.*`` ranges of its trace;
  the benchmark's attribution gives exact numbers on a hand-built trace.
- The harness's traced path reads the six host metrics from the spans and
  no device metric on the CPU.

The days run with each PGD epoch cut to 2 steps (``short_epochs``): the
spans do not depend on the step count, only the ``steps`` counted do.

The card test (``-m cuda``) holds the launches the spans count against the
benchmark's own recorder of the kernel wrappers' calls:

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_spans.py
"""
import time

import pytest
import torch

from repro_torch import sim, spans
from repro_torch.core import solver, stages

CONFIGS = {
    "paper": dict(),
    "risk_joint": dict(joint_spatial=True, n_members=2),
    "closed": dict(streaming=True, mpc=True, telemetry=True),
}
STEPS = 2


@pytest.fixture
def short_epochs(monkeypatch):
    """Every PGD epoch of the day cut to ``STEPS`` steps."""
    epochs = solver.pgd_epochs

    def short(prob, delta, mu, lo, ub, lr_eff, temp, iters):
        return epochs(prob, delta, mu, lo, ub, lr_eff, temp,
                      min(iters, STEPS))

    monkeypatch.setattr(solver, "pgd_epochs", short)


def _setup(kw, days=1, hist=8):
    torch.set_num_threads(1)
    cfg = sim.SimConfig(n_clusters=4, n_campuses=2, n_zones=2,
                        hist_days=hist, **kw)
    lib = sim.forecast_bust_library(days)[:2] if kw.get("mpc") \
        else sim.default_library(days)[:2]
    params = sim.build_batch(cfg, lib, [3], days, device="cpu")
    return cfg, params


def _kids(rec, i):
    return [j for j, s in enumerate(rec.spans) if s.parent == i]


def _names(rec, i):
    return [rec.spans[j].name for j in _kids(rec, i)]


@pytest.mark.parametrize("which", list(CONFIGS))
def test_a_day_records_the_span_tree(which, short_epochs):
    kw = CONFIGS[which]
    cfg, params = _setup(kw)
    with spans.recording() as rec:
        state = sim.make_init(cfg, device="cpu")(params)
    top = [i for i, s in enumerate(rec.spans) if s.parent < 0]
    assert [rec.spans[i].name for i in top] == ["burn_in"]
    want = ["burn_in_day"] * cfg.hist_days + ["contracts"] \
        + (["predictor_init"] if cfg.streaming else [])
    assert _names(rec, top[0]) == want

    with spans.recording() as rec:
        sim.make_rollout(cfg, 1)(params, state)
    S = rec.spans
    assert [s.name for s in S if s.parent < 0] == ["rollout"]
    (day,) = [i for i, s in enumerate(S) if s.name == "day"]
    assert S[S[day].parent].name == "rollout"
    stages_want = ["power", "forecast", "carbon"] \
        + (["ensembles"] if cfg.n_members > 1 else []) \
        + ["optimize", "observe", "slo", "carry"] \
        + (["record"] if cfg.telemetry else []) + ["ledger"]
    assert _names(rec, day) == stages_want
    kids = _kids(rec, day)
    for a, b in zip(kids, kids[1:]):
        assert S[a].t0 <= S[a].t1 <= S[b].t0 <= S[b].t1
    assert S[day].t0 <= S[kids[0]].t0 and S[kids[-1]].t1 <= S[day].t1
    assert rec.self_ns(day) >= 0
    assert rec.self_ns(day) + sum(S[j].host_ns for j in kids) \
        == S[day].host_ns

    (opt,) = [i for i in kids if S[i].name == "optimize"]
    if cfg.joint_spatial:
        assert _names(rec, opt) == ["problem", "solve_joint", "solve_vcc"]
        joint = _kids(rec, opt)[1]
        assert _names(rec, joint) == ["shift", "solve_vcc"] + ["round"] * 8
        for r in _kids(rec, joint)[2:]:
            assert S[r].counts == {"steps": 25}
    else:
        assert _names(rec, opt) == ["problem", "shift", "solve_vcc"]
    solves = [i for i, s in enumerate(S) if s.name == "solve_vcc"]
    assert len(solves) == (2 if cfg.joint_spatial else 1)
    for i in solves:
        assert _names(rec, i) == ["round"] * 20
        assert all(S[r].counts == {"steps": STEPS} for r in _kids(rec, i))
    (obs,) = [i for i in kids if S[i].name == "observe"]
    if cfg.mpc:
        assert _names(rec, obs) == ["observe_mpc"]
        assert _names(rec, _kids(rec, obs)[0]) == ["suffix_solve"] * 24
        for i in _kids(rec, _kids(rec, obs)[0]):
            assert _names(rec, i) == ["round"] * 2
    else:
        assert _names(rec, obs) == []
    # the CPU runs no kernel and builds none
    assert not any(k.startswith("launch.") for s in S for k in s.counts)
    assert not rec.counts


def test_off_records_nothing_and_opens_no_range(monkeypatch, short_epochs):
    """No recorder: ``span`` hands back one shared object, ``count`` does
    nothing, and a whole day runs without a clock read or a profiler range,
    even inside an active profiler."""
    def boom(*a, **k):
        raise AssertionError("the off path reached it")

    monkeypatch.setattr(spans, "record_function", boom)
    monkeypatch.setattr(spans, "_clock", boom)
    assert spans.span("day") is spans.span("round")
    spans.count("steps", 80)
    spans.count("launch.pgd_epoch", rows=4, H=24, iters=80)
    assert spans._REC is None
    cfg, params = _setup({})
    state = sim.make_init(cfg, device="cpu")(params)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.make_rollout(cfg, 1)(params, state)
    assert not [e for e in prof.events()
                if e.name.startswith(spans.PREFIX)]
    assert spans._REC is None


@pytest.mark.parametrize("which", ["paper", "closed"])
def test_recording_leaves_the_rollout_bitwise(which, short_epochs):
    cfg, params = _setup(CONFIGS[which], days=2)
    state = sim.make_init(cfg, device="cpu")(params)
    roll = sim.make_rollout(cfg, 2)
    off = roll(params, state)
    with spans.recording() as rec:
        on = roll(params, state)
    assert sum(s.name == "day" for s in rec.spans) == 2
    a, b = [], []
    stages.map_tensors(a.append, off)
    stages.map_tensors(b.append, on)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_count_adds_to_the_innermost_span_and_keeps_sizes():
    """``count`` adds to the innermost open span, or to the recorder where
    none is open; a size may be named ``n`` (the increment is positional
    only)."""
    with spans.recording() as rec:
        spans.count("cached")
        with spans.span("round"):
            spans.count("steps", 25)
            with spans.span("inner"):
                spans.count("launch.joint_step", rows=96, H=24, n=48)
                spans.count("launch.joint_step", rows=96, H=24, n=48)
            spans.count("steps", 25)
    outer, inner = rec.spans
    assert rec.counts == {"cached": 1} and rec.sizes == {}
    assert outer.counts == {"steps": 50} and outer.sizes == {}
    assert inner.counts == {"launch.joint_step": 2}
    assert inner.sizes["launch.joint_step"] == [
        {"rows": 96, "H": 24, "n": 48}] * 2
    assert inner.parent == 0 and outer.parent == -1
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


def test_recordings_do_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans._REC is None


def test_profile_stages_rows_sum_to_the_day(short_epochs):
    """``stage_rows`` of a risk-aware joint day, by path: the day's row
    first at 100%, its children's host times plus its self time make its
    time, each solve is a row of its own under its parent and holds its
    rounds and steps, and the table prints every row in tree order."""
    from repro_torch.sim import telemetry
    cfg, params = _setup(CONFIGS["risk_joint"])
    state = sim.make_init(cfg, device="cpu")(params)
    rows = telemetry.profile_stages(cfg.stage_config(), params, state)
    by = {r["path"]: r for r in rows}
    assert rows[0]["path"] == "day" and rows[0]["pct"] == 100.0
    children = [r for r in rows if r["depth"] == 1]
    assert [r["stage"] for r in children] == [
        "power", "forecast", "carbon", "ensembles", "optimize", "observe",
        "slo", "carry"]
    total = sum(r["host_ms"] for r in children) + by["day"]["self_ms"]
    assert total == pytest.approx(by["day"]["host_ms"], rel=1e-9)
    opt, joint = "day/optimize", "day/optimize/solve_joint"
    assert [r["path"] for r in rows if r["path"].startswith(opt)] == [
        opt, f"{opt}/problem", joint, f"{joint}/shift",
        f"{joint}/solve_vcc", f"{joint}/solve_vcc/round", f"{joint}/round",
        f"{opt}/solve_vcc", f"{opt}/solve_vcc/round"]
    for r in rows:
        if r["depth"]:
            parent = by[r["path"].rsplit("/", 1)[0]]
            assert r["host_ms"] <= parent["host_ms"]
            assert r["rounds"] <= parent["rounds"]
    assert by[f"{joint}/solve_vcc"]["calls"] == 1
    assert by[f"{opt}/solve_vcc"]["calls"] == 1
    assert by[f"{opt}/solve_vcc"]["rounds"] == 20
    assert by[f"{joint}/round"]["calls"] == 8
    assert by[opt]["rounds"] == 48 and by[joint]["rounds"] == 28
    assert by[opt]["steps"] == 2 * 20 * STEPS + 8 * 25
    assert by["day"]["launches"] == (0, 0, 0, 0)
    assert by["day"]["builds"] == (0, 0)
    table = telemetry.format_stage_table(rows).splitlines()
    assert [line.split()[0] for line in table[2:]] == \
        [r["stage"] for r in rows]
    for line, r in zip(table[2:], rows):
        assert line.startswith(" " * (2 * r["depth"]) + r["stage"])


def test_closed_loop_rounds_are_rows_of_their_own(short_epochs):
    """In the closed loop, the rounds of the day-ahead ``solve_vcc`` and of
    the hourly ``suffix_solve`` re-solves are two rows, each under its own
    parent; the observe stage holds the re-solves, and the benchmark's
    solver reading counts them with the day-ahead solve."""
    from cics_bench import spans as bench_spans
    from repro_torch.sim import telemetry
    cfg, params = _setup(CONFIGS["closed"])
    state = sim.make_init(cfg, device="cpu")(params)
    with spans.recording() as rec:
        sim.make_rollout(cfg, 1)(params, state)
    rows = telemetry.stage_rows(rec)
    by = {r["path"]: r for r in rows}
    day_ahead = by["day/optimize/solve_vcc/round"]
    hourly = by["day/observe/observe_mpc/suffix_solve/round"]
    assert day_ahead["calls"] == 20 and hourly["calls"] == 24 * 2
    assert by["day/optimize/solve_vcc"]["rounds"] == 20
    assert by["day/observe"]["rounds"] == 48
    assert by["day"]["rounds"] == 68
    assert by["day/observe/observe_mpc/suffix_solve"]["calls"] == 24
    host = bench_spans.host_times(rec.spans, 1)
    want = (by["day/optimize/solve_vcc"]["host_ms"]
            + by["day/observe/observe_mpc/suffix_solve"]["host_ms"])
    assert host["solver_ms"] == pytest.approx(want, rel=1e-9)
    assert host["host_ms"]["observe"] == by["day/observe"]["host_ms"]


@pytest.mark.parametrize("which", ["paper", "closed"])
def test_profile_setup_rows(which, short_epochs):
    """``profile_setup``: the burn-in's days, the contracts and (streaming)
    the predictor's warm start under ``burn_in``, then the warm-up
    rollout's day; no kernel built on the CPU."""
    from repro_torch.sim import telemetry
    cfg, params = _setup(CONFIGS[which])
    state, rows = telemetry.profile_setup(cfg, params, device="cpu")
    assert isinstance(state, stages.SimState)
    by = {r["path"]: r for r in rows}
    tops = [r["path"] for r in rows if r["depth"] == 0]
    assert tops == ["burn_in", "rollout"]
    assert [r["path"] for r in rows if r["depth"] == 1] == [
        "burn_in/burn_in_day", "burn_in/contracts"] \
        + (["burn_in/predictor_init"] if cfg.streaming else []) \
        + ["rollout/day"]
    assert by["burn_in/burn_in_day"]["calls"] == cfg.hist_days
    assert sum(r["pct"] for r in rows if r["depth"] == 0) \
        == pytest.approx(100.0)
    assert by["rollout"]["launches"] == (0, 0, 0, 0)
    assert all(r["builds"] == (0, 0) for r in rows)


def test_build_spans_count_built_and_cached(tmp_path, monkeypatch):
    """``nvcc.build`` is a ``build`` span that counts ``built`` where it
    compiled and ``cached`` where ``build/`` held the library; the stage
    rows add them up (nvcc itself is stood in for: the CPU has none)."""
    from repro_torch.kernels import nvcc
    from repro_torch.sim import telemetry
    src = tmp_path / "k.cu"
    src.write_text("// a kernel")
    calls = []

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return Done()

    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(nvcc.subprocess, "run", fake_run)
    with spans.recording() as rec:
        with spans.span("rollout"):
            first = nvcc.build(src)[0]
            again = nvcc.build(src)[0]
    assert first == again and first.exists() and len(calls) == 1
    assert [s.name for s in rec.spans] == ["rollout", "build", "build"]
    assert [s.counts for s in rec.spans[1:]] == [{"built": 1},
                                                 {"cached": 1}]
    rows = telemetry.stage_rows(rec, root=None)
    assert [(r["path"], r["calls"], r["builds"]) for r in rows] == [
        ("rollout", 1, (1, 1)), ("rollout/build", 2, (1, 1))]


def test_profiled_spans_are_ranges_of_the_trace(short_epochs):
    """Recorded under the profiler, every span is a ``cics.<name>`` range
    of the Chrome trace; the benchmark's attribution finds the window and
    no device operation on the CPU."""
    from cics_bench import spans as bench_spans
    cfg, params = _setup({})
    state = sim.make_init(cfg, device="cpu")(params)
    roll = sim.make_rollout(cfg, 1)
    with spans.recording() as rec:
        events = bench_spans._profiled(lambda: roll(params, state), False)
    ranges = sorted(e["name"] for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(spans.PREFIX))
    assert ranges == sorted(spans.PREFIX + s.name for s in rec.spans)
    assert bench_spans.attribute(events) == {}


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_attribution_on_a_hand_built_trace():
    """Window [0, 100) us. Ranges: day [0, 60) holding power [5, 30)
    (and its child round [20, 25)) and carbon [30, 50); a launch at 55 in
    the day's own glue; one at 70 after the day. Kernels: power's at
    [10, 20) and [15, 25) (overlapping: busy 15), round's at [40, 45), a
    memcpy of carbon's at [45, 50) and its kernel at [50, 52), the day's
    at [60, 70), and one launched outside every span at [80, 90); a
    synchronising call in power at [26, 29). Each operation and call is its
    innermost span's, or with ``paths`` every open span's, by path."""
    from cics_bench import spans as bench_spans
    W = bench_spans.WINDOW
    ev = [
        _ev(W, "user_annotation", 0, 100),
        _ev(W, "gpu_user_annotation", 0, 100),
        _ev("cics.day", "user_annotation", 0, 60),
        _ev("cics.power", "user_annotation", 5, 25),
        _ev("cics.round", "user_annotation", 20, 5),
        _ev("cics.carbon", "user_annotation", 30, 20),
        _ev("aten::mul", "cpu_op", 6, 2),
        _ev("cudaLaunchKernel", "cuda_runtime", 6, 1, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 8, 1, corr=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 21, 1, corr=3),
        _ev("cudaMemcpyAsync", "cuda_runtime", 31, 1, corr=4),
        _ev("cudaLaunchKernel", "cuda_runtime", 33, 1, corr=5),
        _ev("cudaLaunchKernel", "cuda_runtime", 55, 1, corr=6),
        _ev("cudaLaunchKernel", "cuda_runtime", 70, 1, corr=7),
        _ev("cudaStreamSynchronize", "cuda_runtime", 26, 3, corr=9),
        _ev("k1", "kernel", 10, 10, corr=1),
        _ev("k2", "kernel", 15, 10, corr=2),
        _ev("k3", "kernel", 40, 5, corr=3),
        _ev("Memcpy HtoD", "gpu_memcpy", 45, 5, corr=4),
        _ev("k5", "kernel", 50, 2, corr=5),
        _ev("k6", "kernel", 60, 10, corr=6),
        _ev("k7", "kernel", 80, 10, corr=7),
        _ev("k8", "kernel", 120, 5, corr=8),      # after the window
    ]
    got = bench_spans.attribute(ev)
    want = {
        # busy [10, 25); the gap [0, 10) ended by its first kernel; a
        # synchronise of 3 us at 26
        "power": {"busy_ms": 0.015, "launches": 2, "idle_ms": 0.010,
                  "wait_ms": 0.003},
        # busy [40, 45); the gap [25, 40)
        "round": {"busy_ms": 0.005, "launches": 1, "idle_ms": 0.015,
                  "wait_ms": 0.0},
        # busy [45, 52) (a memcpy and a kernel), no gap before it
        "carbon": {"busy_ms": 0.007, "launches": 1, "idle_ms": 0.0,
                   "wait_ms": 0.0},
        # busy [60, 70); the gap [52, 60)
        "day": {"busy_ms": 0.010, "launches": 1, "idle_ms": 0.008,
                "wait_ms": 0.0},
    }
    assert got.keys() == want.keys()
    for name, nums in want.items():
        assert got[name] == pytest.approx(nums, abs=1e-12), name
    # by path: an operation counts for every span open at its launch
    got = bench_spans.attribute(ev, paths=True)
    want = {
        "day": {"busy_ms": 0.037, "launches": 5, "idle_ms": 0.033,
                "wait_ms": 0.003},
        "day/power": {"busy_ms": 0.020, "launches": 3, "idle_ms": 0.025,
                      "wait_ms": 0.003},
        "day/power/round": want["round"],
        "day/carbon": want["carbon"]}
    assert got.keys() == want.keys()
    for name, nums in want.items():
        assert got[name] == pytest.approx(nums, abs=1e-12), name


def _tiny_cell():
    """The faults test's smoke cell: 8 clusters, two scenarios of one
    fleet, 28 days of history, one-day rollouts."""
    from cics_bench import spec
    cell = spec.Cell("cics-paper.sweep880")
    cell.config["sim"].update(n_clusters=8, n_campuses=2, n_zones=4,
                              hist_days=28)
    picked = [s for s in cell.traffic["scenarios"]
              if s["name"] in ("demand_surge", "perfect_storm")]
    cell.traffic = dict(cell.traffic, seeds_per_scenario=1, scenarios=picked)
    cell.workload["rollout_days"] = 1
    return cell


HOST_METRICS = ("power_stage_host_ms", "carbon_stage_host_ms",
                "observe_stage_host_ms", "optimize_stage_host_ms",
                "solver_host_ms", "day_self_host_ms")


def test_the_traced_path_reads_the_host_metrics(short_epochs):
    """The harness's traced window and the per-layer readings at the
    tiny cell on the CPU: a number for each host metric from the spans,
    the solvers inside the optimize stage, and no device reading."""
    from cics_bench import harness, spec
    from cics_bench.traffic import generator
    from repro_torch.sim import engine
    torch.set_num_threads(1)
    cell = _tiny_cell()
    sim_cfg = cell.sim
    dims = {k: sim_cfg[k] for k in ("n_clusters", "n_campuses", "n_zones",
                                    "pds_per_cluster")}
    cfg = engine.SimConfig(**sim_cfg)
    params = stages.SimParams(**generator.build_batch(
        cell.traffic, dims, 2147483659, "cpu"))
    state = engine.make_init(cfg, device="cpu")(params)
    log = harness.Run()
    t0 = time.perf_counter()
    harness._traced(cell, cfg, params, state, log, "cpu")
    print(f"traced path {time.perf_counter() - t0:.1f} s")
    got = {m["name"]: spec.reader(m["name"])(log) for m in cell.per_layer}
    for name in HOST_METRICS:
        assert isinstance(got[name], float) and got[name] > 0.0, name
    assert got["solver_host_ms"] <= got["optimize_stage_host_ms"]
    assert got["power_stage_device_ms"] is None


@pytest.mark.cuda
def test_launch_counters_match_the_benchmark_recorder():
    """A paper day on the card: the ``launch.pgd_epoch`` sizes the spans
    keep are the ones the benchmark's ``LaunchRecorder`` takes from the
    wrapper's arguments, launch for launch (20 a day: one an outer
    round)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from cics_bench import harness
    from cics_bench.costs import pgd_epoch as cost
    cfg = sim.SimConfig(n_clusters=48, n_campuses=6, n_zones=6,
                        pds_per_cluster=4, hist_days=35)
    params = sim.build_batch(cfg, sim.default_library(1)[:2], [0, 1], 1,
                             device="cuda")
    state = sim.make_init(cfg)(params)
    roll = sim.make_rollout(cfg, 1)
    roll(params, state)
    with harness.LaunchRecorder([cost]) as seen:
        with spans.recording() as rec:
            roll(params, state)
    torch.cuda.synchronize()
    counted = [size for s in rec.spans
               for size in s.sizes.get("launch.pgd_epoch", ())]
    assert len(counted) == 20
    assert counted == seen.launches["pgd_epoch"]
    assert sum(s.counts.get("launch.pgd_epoch", 0) for s in rec.spans) == 20
    rounds = [s for s in rec.spans if s.name == "round"]
    assert all(s.counts.get("launch.pgd_epoch") == 1 for s in rounds)
