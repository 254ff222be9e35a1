"""The device trace of a window: ``torch.profiler`` over CPU and CUDA
activity, its Chrome trace read back into kernel intervals, the device's
busy time (the union of its operations' intervals), time by kernel name,
the host's time inside CUDA runtime calls, and the idle gaps named by
what the host was doing when each ended.

The trace is written to a file in the temporary directory, read and
deleted at once.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

WINDOW = "cics_bench.traced_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}


def _union(intervals: List[Tuple[float, float]]):
    """Sorted, merged (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _matches(name: str, kernels: Sequence[str]) -> bool:
    return any(re.search(r"(^|[\s:*&])" + re.escape(k) + r"\s*[(<]", name)
               or name == k for k in kernels)


class Trace:
    """What one traced window shows. Times in seconds."""

    def __init__(self, events: List[Dict]):
        spans = [e for e in events if e.get("name") == WINDOW
                 and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        if not spans:
            raise ValueError(f"the trace has no {WINDOW} span")
        w0 = float(spans[0]["ts"])
        w1 = w0 + float(spans[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS
               and w0 <= float(e["ts"]) < w1]
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        iv = [(float(e["ts"]), min(float(e["ts"]) + float(e.get("dur", 0)),
                                   w1)) for e in dev]
        self.busy = _union(iv)
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6
        by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[e["name"]] += float(e.get("dur", 0)) * 1e-6
        self.by_name = dict(by_name)
        self.gaps = self._gaps(events, dev, w0, w1)
        calls = sorted((float(e["ts"]), float(e.get("dur", 0)), e["name"])
                       for e in events if e.get("ph") == "X"
                       and e.get("cat") == "cuda_runtime"
                       and w0 <= float(e["ts"]) < w1)
        if calls and "Synchronize" in calls[-1][2]:
            calls = calls[:-1]
        self.runtime_s = (sum(d for _, d, _ in calls) * 1e-6 if calls
                          else None)

    def _gaps(self, events, dev, w0, w1):
        """Idle time by what the host was doing as each gap ended: the
        innermost host op that launched the device op after the gap (or
        the launch call itself where no op encloses it)."""
        launch = {}
        for e in events:
            if e.get("cat") == "cuda_runtime" and e.get("ph") == "X":
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch[c] = e
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                      and e.get("name") != WINDOW)
        starts = [h[0] for h in host]

        def doing(t):
            i = bisect.bisect_right(starts, t)
            best = None
            for j in range(i - 1, max(i - 64, -1), -1):
                s, e, name = host[j]
                if s <= t <= e and (best is None or s >= best[0]):
                    best = (s, name)
            return best[1] if best else None

        first = {}
        for e in dev:
            first.setdefault(float(e["ts"]), e)
        gaps: Dict[str, float] = defaultdict(float)
        prev_end = w0
        for s, e in self.busy:
            if s > prev_end:
                nxt = first.get(s)
                name = "window start"
                if nxt is not None:
                    c = (nxt.get("args") or {}).get("correlation")
                    call = launch.get(c)
                    if call is not None:
                        name = doing(float(call["ts"])) or call["name"]
                    else:
                        name = f"before {nxt['name'][:60]}"
                gaps[name] += (s - prev_end) * 1e-6
            prev_end = max(prev_end, e)
        if w1 > prev_end:
            gaps["window end"] += (w1 - prev_end) * 1e-6
        return dict(gaps)

    def kernel_seconds(self, kernels: Sequence[str]) -> float:
        return sum(float(e.get("dur", 0)) for e in self.kernels
                   if _matches(e["name"], kernels)) * 1e-6

    def breakdown(self, top: int = 10):
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def record(fn, device_type: str = "cuda"):
    """Run ``fn()`` under the profiler inside a ``WINDOW`` span that ends
    after the device has finished; return (fn's result, ``Trace``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def sync():
        if device_type == "cuda":
            torch.cuda.synchronize()

    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)
