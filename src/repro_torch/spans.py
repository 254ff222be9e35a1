"""Spans and counters inside the program, off unless a caller records.

``span(name)`` marks a layer boundary (a rollout, a day, a stage, a solve,
a dual-ascent round), ``count(key, n, **sizes)`` adds to the innermost open
span's counters (a kernel launch with its sizes, a round's inner steps, a
kernel build), and ``recording()`` turns both on for the calls inside it
and yields the ``Recorder`` that keeps them in memory. The caller reads the
recorder after the run and writes out what it wants; nothing here writes a
file.

Off (the default) ``span`` returns one shared no-op context manager: a
module flag read and a call, no clock read, no allocation, no profiler
range. On, each span appends a ``Span`` record (name, parent index, host
start and end from ``time.perf_counter_ns``, its counters) and, while a
``torch.profiler`` is active, enters
``torch.profiler.record_function("cics.<name>")``, so that the span lands
in the profiler's Chrome trace on its clock, around the kernels and launch
calls it encloses.

A span reads no CPU-time clock: on the H100 machine the benchmark runs on,
``time.thread_time_ns`` took 9.5-37 us a call and reading it at every span
slowed the risk-aware joint day by ~30 ms (8%), where the monotonic clock
takes 0.06 us (PERF.md §6).

The module imports nothing of the package, so ``core``, ``sim`` and
``kernels`` all import it.
"""
from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter_ns as _clock
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

PREFIX = "cics."

_REC: Optional["Recorder"] = None     # the recorder while recording()


class Span:
    """One recorded span: ``name``, ``parent`` (index into
    ``Recorder.spans``, -1 at the top), host ``t0`` / ``t1`` in ns,
    ``counts`` (key -> total) and ``sizes`` (key -> one dict a ``count``
    call that passed sizes)."""
    __slots__ = ("name", "parent", "t0", "t1", "counts", "sizes")

    def __init__(self, name: str, parent: int):
        self.name, self.parent = name, parent
        self.t0 = self.t1 = 0
        self.counts: Dict[str, int] = {}
        self.sizes: Dict[str, List[Dict[str, object]]] = {}

    @property
    def host_ns(self) -> int:
        return self.t1 - self.t0


class Recorder:
    """What one ``recording()`` saw: ``spans`` in the order they opened,
    and ``counts`` / ``sizes`` of ``count`` calls made with no span open."""

    def __init__(self):
        self.spans: List[Span] = []
        self.open: List[int] = []
        self.counts: Dict[str, int] = {}
        self.sizes: Dict[str, List[Dict[str, object]]] = {}

    def children(self) -> List[List[int]]:
        """Each span's children, by index."""
        out: List[List[int]] = [[] for _ in self.spans]
        for i, s in enumerate(self.spans):
            if s.parent >= 0:
                out[s.parent].append(i)
        return out

    def self_ns(self, i: int, children=None) -> int:
        """Span ``i``'s host time less the part its children cover (they
        run one after another on one thread, so never overlap)."""
        kids = self.children()[i] if children is None else children[i]
        return self.spans[i].host_ns - sum(self.spans[j].host_ns
                                           for j in kids)

    def ancestors(self, i: int) -> Iterator[int]:
        j = self.spans[i].parent
        while j >= 0:
            yield j
            j = self.spans[j].parent


class _Off:
    """The shared no-op span."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "index", "range")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        parent = rec.open[-1] if rec.open else -1
        self.index = len(rec.spans)
        rec.spans.append(Span(name, parent))
        self.range = None

    def __enter__(self):
        rec = self.rec
        s = rec.spans[self.index]
        if torch._C._autograd._profiler_enabled():
            self.range = record_function(PREFIX + s.name)
            self.range.__enter__()
        rec.open.append(self.index)
        s.t0 = _clock()
        return s

    def __exit__(self, *exc):
        s = self.rec.spans[self.index]
        s.t1 = _clock()
        self.rec.open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's call: a recorded ``Span``
    inside ``recording()``, the shared no-op otherwise."""
    if _REC is None:
        return _OFF
    return _On(_REC, name)


def count(key: str, n: int = 1, /, **sizes) -> None:
    """Add ``n`` to ``key`` on the innermost open span (on the recorder
    where none is open) and keep ``sizes``, if given, as one entry of its
    ``sizes[key]`` (``n`` is positional only, so a size may be named
    ``n``); nothing unless recording."""
    rec = _REC
    if rec is None:
        return
    where = rec.spans[rec.open[-1]] if rec.open else rec
    where.counts[key] = where.counts.get(key, 0) + n
    if sizes:
        where.sizes.setdefault(key, []).append(sizes)


@contextmanager
def recording():
    """Record spans and counts for the calls inside; yields the
    ``Recorder``. Recordings do not nest."""
    global _REC
    if _REC is not None:
        raise RuntimeError("spans.recording() is already on")
    _REC = rec = Recorder()
    try:
        yield rec
    finally:
        _REC = None


__all__ = ["Span", "Recorder", "span", "count", "recording", "PREFIX"]
