"""The program's own spans (``repro_torch.spans``), read for the per-layer
metrics that name a stage, a solver or the day's glue.

``read(ctx)`` runs once per traced run, from a metric's ``measure(ctx)``,
and keeps its result on ``ctx``. It drives two more rollouts of the cell's
days from the burned-in state (``ctx.params``, ``ctx.state``):

(a) under ``spans.recording()`` alone: the host's times, each span name's
    host milliseconds over its outermost spans (``host_ms``), its self
    milliseconds (``self_ms``: less what its children cover), and the
    solver spans' (``solver_ms``: the outermost ``solve_vcc``,
    ``solve_joint`` and ``suffix_solve``, the closed loop's hourly
    re-solves, which lie inside its ``observe`` stage), each a day's mean;
(b) under ``spans.recording()`` inside the profiler (CPU and CUDA
    activity): each device operation goes to the innermost ``cics.*`` range
    around the launch call that queued it (matched by the ``correlation``
    id, as ``trace.py`` matches them), and each span name gets the union
    of its operations' busy intervals, its kernel launches, the idle time
    of every gap that one of its operations ended and the host's time in
    synchronising runtime calls (``device``), each a day's mean; empty
    where the trace holds no device operation.

Where the program keeps no spans (a checkout before them), ``read`` gives
None and the metrics read nothing. The profiler's trace is written to a
file in the temporary directory, read and deleted at once.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence

WINDOW = "cics_bench.span_window"
PREFIX = "cics."
SOLVERS = ("solve_vcc", "solve_joint", "suffix_solve")
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def read(ctx):
    """The spans' readings for ``ctx`` (``harness.Context``), taken once."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = _take(ctx)
    return ctx.program_spans


def _take(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    import torch

    from repro_torch.sim import engine
    on_card = ctx.device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    days = ctx.cell.days
    roll = engine.make_rollout(ctx.cfg, days)
    sync()
    with spans.recording() as rec:
        roll(ctx.params, ctx.state)
    sync()
    out = host_times(rec.spans, days)
    with spans.recording():
        events = _profiled(lambda: roll(ctx.params, ctx.state), on_card)
    out["device"] = {name: {k: v / days for k, v in got.items()}
                     for name, got in attribute(events).items()}
    return out


def _outer(records: Sequence, i: int, names) -> bool:
    """Whether no ancestor of record ``i`` is named in ``names``."""
    j = records[i].parent
    while j >= 0:
        if records[j].name in names:
            return False
        j = records[j].parent
    return True


def outer_ms(records: Sequence, names) -> float:
    """Host ms over the spans named in ``names`` that no span so named
    encloses."""
    return 1e-6 * sum(r.t1 - r.t0 for i, r in enumerate(records)
                      if r.name in names and _outer(records, i, names))


def host_times(records: Sequence, days: int) -> Dict:
    """A day's mean host ms by span name (``host_ms``, outermost spans;
    ``self_ms``, all spans less their children) and of the solvers
    (``solver_ms``), from the program's span records (``name``,
    ``parent``, ``t0``, ``t1`` in ns)."""
    child_ns: Dict[int, int] = defaultdict(int)
    for r in records:
        if r.parent >= 0:
            child_ns[r.parent] += r.t1 - r.t0
    names = {r.name for r in records}
    self_ms: Dict[str, float] = defaultdict(float)
    for i, r in enumerate(records):
        self_ms[r.name] += 1e-6 * (r.t1 - r.t0 - child_ns[i]) / days
    return {"host_ms": {n: outer_ms(records, {n}) / days for n in names},
            "self_ms": dict(self_ms),
            "solver_ms": outer_ms(records, set(SOLVERS)) / days}


def _profiled(fn, on_card: bool) -> List[Dict]:
    """``fn()`` under the profiler inside a ``WINDOW`` range that ends after
    the device has finished; the Chrome trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            if on_card:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def attribute(events: List[Dict], paths: bool = False
              ) -> Dict[str, Dict[str, float]]:
    """Device time by the span that launched it, from a Chrome trace whose
    ``WINDOW`` range bounds the run: for each span name (``cics.`` taken
    off; operations launched outside every span are left out), ``busy_ms``
    (the union of its operations' intervals inside the window),
    ``launches`` (its kernels) and ``idle_ms`` (the device's idle gaps,
    the window's start included, that one of its operations ended) and
    ``wait_ms`` (the host's time in the CUDA runtime's synchronising calls
    made inside it: where the host waited for the device). An operation or
    a call is the innermost open span's; with ``paths``, every open
    span's, each keyed by its path of names from the outermost
    ("rollout/day/power": a stage then holds its solvers' work). Empty
    where the window holds no device operation."""
    def full(e):
        return e.get("ph") == "X" and "dur" in e

    win = [e for e in events if full(e) and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"][len(PREFIX):]) for e in events
                     if full(e) and e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith(PREFIX)),
                    key=lambda a: (a[0], -a[1]))
    calls = sorted((float(e["ts"]), e["args"]["correlation"],
                    float(e["dur"]) if "Synchronize" in e["name"] else 0.0)
                   for e in events if full(e)
                   and e.get("cat") == "cuda_runtime"
                   and "correlation" in (e.get("args") or {}))
    # the innermost range open at each launch call: the ranges nest, so a
    # stack swept in time order holds the open ones
    owner: Dict[object, str] = {}
    stack: List = []
    k = 0
    waits: Dict[str, float] = defaultdict(float)
    for t, corr, wait in calls:
        while k < len(ranges) and ranges[k][0] <= t:
            while stack and stack[-1][1] <= ranges[k][0]:
                stack.pop()
            stack.append(ranges[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            names = [r[2] for r in stack if r[1] > t]
            owner[corr] = tuple("/".join(names[:k + 1])
                                for k in range(len(names))) if paths \
                else (stack[-1][2],)
            for name in owner[corr]:
                waits[name] += wait
    ops = sorted([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1),
                   owner.get((e.get("args") or {}).get("correlation"), ()),
                   e.get("cat") == "kernel")
                  for e in events if full(e) and e.get("cat") in DEVICE_CATS
                  and w0 <= float(e["ts"]) < w1], key=lambda o: o[:2])
    if not ops:
        return {}
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"busy_ms": 0.0, "launches": 0, "idle_ms": 0.0,
                 "wait_ms": 0.0})
    for name, wait in waits.items():
        out[name]["wait_ms"] = 1e-3 * wait
    by_name: Dict[str, List] = defaultdict(list)
    for s, e, names, kernel in ops:
        for name in names:
            by_name[name].append((s, e))
            out[name]["launches"] += int(kernel)
    for name, iv in by_name.items():
        out[name]["busy_ms"] = 1e-3 * sum(e - s for s, e in _union(iv))
    # each idle gap goes to the span of the operation that ended it
    prev = w0
    for s, e, names, _ in ops:
        if s > prev:
            for name in names:
                out[name]["idle_ms"] += 1e-3 * (s - prev)
        prev = max(prev, e)
    return dict(out)
