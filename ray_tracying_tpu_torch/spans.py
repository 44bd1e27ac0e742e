"""Spans and counters of the port's phases, recorded only while a
torch.profiler session is active.

    with spans.span("rtt.level", depth=d, lanes=w):
        ...
    with spans.read("image"):       # one device-to-host read
        out = image.cpu()

With the profiler off, `span` and `read` return one shared context that
does nothing: a site costs one check of the profiler's flag.  While a
session records, a span enters `torch.profiler.record_function(name)`, so
that the phase is an event of the profiler's trace, on the clock of its
CUDA kernels, and on exit appends a record to a bounded buffer:

    name      the span's name (the package's are "rtt.*")
    start_ns, end_ns
              Unix nanoseconds (`time.time_ns()`), the clock of the trace's
              `baseTimeNanoseconds` plus its `ts` in microseconds
    id, parent
              the span's id and its parent's (None for a root)
    unit      the id of the root span it belongs to: one frame or one step
    counts    its counters (`span(name, **counts)`, `Span.add`)

Each thread keeps its own stack of open spans.  A span opened on a thread
with none open while a root is open elsewhere (autograd's device thread
running a level's backward) joins that root's unit, under the innermost
span open on the root's thread.  `records()` returns a copy of the buffer
and `clear()` empties it; past `CAP` records a span is counted in
`dropped()` instead.  `self_ns` gives each span's self time.

The phases and counters the package records:
  rtt.frame (root; rays)  render/pipeline.py::_render_tiles, a frame
  rtt.prep                the frame's host builds: LBVH, chunks, the scene's
                          move, the fused level's tables and windows
  rtt.tile (lanes)        a pass of the tile loop
  rtt.rays                the tile's primary rays
  rtt.level (depth, lanes)
                          a bounce level, at the width it is launched
  rtt.fuzz                a fused level's unit-ball draws
  rtt.shrink (kept, dropped)
                          the fused path's queue shrink
  rtt.hit, rtt.materials, rtt.shade, rtt.spawn
                          the general path's passes of a level
  rtt.post                the mean over samples, quantisation, the write
  rtt.read (what)         a device-to-host read
  rtt.step (root; rays)   diff/optimize.py::fit, a step
  rtt.forward, rtt.backward, rtt.adam
                          the step's render and loss, its backward, Adam
  rtt.level_backward (lanes), .recompute, .grad
                          the fused level's backward
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

# Records kept; spans past it are counted in dropped().
CAP = 1 << 16

_recording = torch._C._autograd._profiler_enabled


class _Off:
    """The context every site gets while the profiler is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


_OFF = _Off()


class _Buffer:
    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.root = None  # (unit id, the root thread's stack) while a root is open

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def append(self, rec: dict):
        with self.lock:
            if len(self.records) < CAP:
                self.records.append(rec)
            else:
                self.dropped += 1


_BUF = _Buffer()


class Span:
    """One open span; `add(**counts)` sets counters known only inside it."""

    __slots__ = ("name", "counts", "id", "parent", "unit", "start_ns", "_stack", "_rf")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def add(self, **counts):
        self.counts.update(counts)

    def __enter__(self):
        stack = _BUF.stack()
        self.id = next(_BUF.ids)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        elif _BUF.root is not None:
            self.unit, root_stack = _BUF.root
            inner = root_stack[-1:]  # a slice: the root thread may pop meanwhile
            self.parent = inner[0].id if inner else self.unit
        else:
            self.parent, self.unit = None, self.id
            _BUF.root = (self.id, stack)
        stack.append(self)
        self._stack = stack
        self.start_ns = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._rf.__exit__(exc_type, exc, tb)
        end = time.time_ns()
        self._stack.pop()
        if self.parent is None:
            _BUF.root = None
        _BUF.append({"name": self.name, "start_ns": self.start_ns, "end_ns": end, "id": self.id,
                     "parent": self.parent, "unit": self.unit, "counts": self.counts})
        return False


def span(name: str, **counts):
    """A span of `name` with `counts`, or the shared no-op context while no
    profiler session records."""
    return Span(name, counts) if _recording() else _OFF


def read(what: str):
    """A span around one device-to-host read; `what` names it."""
    return span("rtt.read", what=what)


def records() -> list:
    """A copy of the records, in the order the spans closed."""
    with _BUF.lock:
        return [dict(r, counts=dict(r["counts"])) for r in _BUF.records]


def dropped() -> int:
    """Spans not recorded because the buffer held CAP records."""
    return _BUF.dropped


def clear():
    """Empty the buffer and its count of dropped spans."""
    with _BUF.lock:
        _BUF.records = []
        _BUF.dropped = 0


def self_ns(recs) -> dict:
    """{id: the span's duration less the part of it its children cover}."""
    kids = {}
    for r in recs:
        kids.setdefault(r["parent"], []).append((r["start_ns"], r["end_ns"]))
    out = {}
    for r in recs:
        a0, b0 = r["start_ns"], r["end_ns"]
        covered, t = 0, a0
        for a, b in sorted(kids.get(r["id"], ())):
            a, b = max(a, t), min(b, b0)
            if b > a:
                covered += b - a
                t = b
        out[r["id"]] = (b0 - a0) - covered
    return out
