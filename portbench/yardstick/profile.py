"""The device trace of a run with --trace 1, from torch.profiler, read
back into intervals.

The units before the traced ones, past the first, run untraced: their
median host-clock time is the untraced pace (`Tracer.pace_units`).  The
traced units run in two stretches of the window.  First a few units under
CUDA activity alone (CUPTI: kernels, copies and sets): the device
metrics, `busy_s` and `window_s` read this stretch.  Tracing still costs
the host time a launch, so a unit of many small launches runs slower
traced (a fit step about twice as long), and a share of the unit's time
is taken against the untraced pace, not the traced span.  It is bounded
on the device by two marker kernels, one launched just before its first
unit and one just after its last (each after a synchronize), so that the
host's time before the first kernel and after the last one counts as
idle.  The marker is PyTorch's spin kernel (`torch.cuda._sleep`), which
the program never launches and which needs no tensor made for it; the
span runs between the first and last kernels of that name, and a device
operation outside them (one still in flight as the profiler opens, a copy
recorded after the last marker) is left out.  Then one more unit under
CPU and CUDA activity, whose host operations name what the host was doing
in each idle gap (`breakdown`'s idle_gaps); recording every host
operation slows that unit, so no metric reads it.  An annotation, `portbench.window`,
marks that unit's span, and `portbench.unit` the unit.

Each chrome trace is written to a temporary directory (under TMPDIR),
read and deleted at once.  Host and device timestamps share one clock
(microseconds)."""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import re
import tempfile

WINDOW = "portbench.window"
UNIT = "portbench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # the name of torch.cuda._sleep's kernel
MARKER_CYCLES = 1000
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# PyTorch's own kernels: its namespaces and the libraries it links (cub,
# thrust).  The port's kernels live in other namespaces (rtt, anonymous)
# or none, so a renamed port kernel still counts as the port's.
_TORCH_NAME = re.compile(r"(^|[^\w])(at|at_cuda_detail|c10|cub|thrust|cutlass)::")


def is_torch_kernel(name: str) -> bool:
    return bool(_TORCH_NAME.search(name))


def _events(prof) -> list:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


class Tracer:
    """torch.profiler over units skip .. skip + units - 1 (CUDA activity
    alone) and over unit skip + units (CPU and CUDA activity).  The loop
    calls before(i), runs unit i inside scope(i), then calls after(i)."""

    def __init__(self, skip: int, units: int):
        self.pace_units = list(range(1, skip))
        self.device_units = list(range(skip, skip + units))
        self.host_unit = skip + units
        self.end = skip + units + 1  # the first unit after the traced ones
        self._prof = self._ann = self._device = None

    def before(self, i: int):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if i == self.device_units[0]:
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda._sleep(MARKER_CYCLES)
        elif i == self.host_unit:
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._ann = record_function(WINDOW)
            self._ann.__enter__()

    def scope(self, i: int):
        from torch.profiler import record_function

        return record_function(UNIT) if i == self.host_unit else contextlib.nullcontext()

    def after(self, i: int):
        import torch

        if i == self.device_units[-1]:
            torch.cuda.synchronize()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            # read before the next session starts: a profile exported after
            # another session has run reads every duration as 0
            self._device = Trace.marked(_events(self._prof), len(self.device_units))
        elif i == self.host_unit:
            torch.cuda.synchronize()
            self._ann.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self._device.host_trace = Trace.annotated(_events(self._prof))
        else:
            return
        self._prof = None

    def read(self) -> "Trace":
        """The device stretch's trace, with the host unit's for the
        breakdown's idle gaps."""
        return self._device


class Trace:
    """A traced span's device and host intervals, in microseconds."""

    def __init__(self, t0: float, t1: float, device: list, host: list, units: int):
        self.t0, self.t1, self.units = t0, t1, units
        self.device = device  # (category, name, start, duration)
        self.kernels = [(n, ts, dur) for c, n, ts, dur in device if c == "kernel"]
        self.host = host      # (name, start, duration)
        self.host_trace = None

    @staticmethod
    def _spans(events: list) -> list:
        return [e for e in events if e.get("ph") == "X" and "dur" in e]

    @classmethod
    def annotated(cls, events: list) -> "Trace":
        """A span marked by the `portbench.window` annotation (CPU and CUDA
        activity)."""
        ev = cls._spans(events)
        win = [e for e in ev if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no window annotation")
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
        units = sum(1 for e in ev if e.get("name") == UNIT and e.get("cat") == "user_annotation")

        def inside(e):
            return float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0

        device = [(e["cat"], e["name"], float(e["ts"]), float(e["dur"]))
                  for e in ev if e.get("cat") in DEVICE_CATS and inside(e)]
        host = [(e["name"], float(e["ts"]), float(e["dur"]))
                for e in ev if e.get("cat") in HOST_CATS and inside(e) and e.get("name") != WINDOW]
        return cls(t0, t1, device, host, units)

    @classmethod
    def marked(cls, events: list, units: int) -> "Trace":
        """A span of CUDA activity alone, bounded by the first and last
        kernels named as the marker (MARKER), which are left out: it runs
        from the first one's end to the last one's start, and holds the
        device operations that start between them."""
        device = sorted(((e["cat"], e["name"], float(e["ts"]), float(e["dur"]))
                         for e in cls._spans(events) if e.get("cat") in DEVICE_CATS),
                        key=lambda d: d[2])
        marks = [d for d in device if d[0] == "kernel" and MARKER in d[1]]
        if len(marks) < 2:
            raise ValueError(f"the device trace holds {len(marks)} of its two markers")
        first, last = marks[0], marks[-1]
        inside = [d for d in device if first[2] < d[2] < last[2]]
        return cls(first[2] + first[3], last[2], inside, [], units)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """Union of the device's kernels, copies and sets, clipped to the span."""
        spans = sorted((max(ts, self.t0), min(ts + dur, self.t1)) for _, _, ts, dur in self.device)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def gaps(self) -> list:
        """(start, end) of each stretch of the span with no device activity."""
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_at(self, t: float) -> str:
        """The innermost (shortest) host operation running at time t."""
        return self.hosts_at([t])[0]

    def hosts_at(self, times) -> list:
        """host_at of each of `times`, in one sweep over the host operations."""
        order = sorted(range(len(times)), key=lambda i: times[i])
        events = sorted(self.host, key=lambda e: e[1])
        out = ["(no host operation)"] * len(times)
        heap, k = [], 0
        for i in order:
            t = times[i]
            while k < len(events) and events[k][1] <= t:
                name, ts, dur = events[k]
                heapq.heappush(heap, (dur, ts + dur, name))
                k += 1
            while heap and heap[0][1] < t:  # ended: it stays ended for later times
                heapq.heappop(heap)
            if heap:
                out[i] = heap[0][2]
        return out

    def device_seconds(self, pred) -> float:
        """Seconds of device activity (kernels, copies, sets) whose
        (category, name) satisfies pred."""
        return sum(dur for c, n, _, dur in self.device if pred(c, n)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle gaps
        summed by what the host was doing in each (in host_trace, the unit
        traced with the host's operations, where there is one), the
        longest first."""
        ops = {}
        for _, n, _, dur in self.device:
            ops[n[:200]] = ops.get(n[:200], 0.0) + dur * 1e-6
        idle = {}
        host = self.host_trace or self
        gaps = host.gaps()
        for (a, b), k in zip(gaps, host.hosts_at([(a + b) / 2 for a, b in gaps])):
            idle[k[:200]] = idle.get(k[:200], 0.0) + (b - a) * 1e-6
        by = lambda kv: -kv[1]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=by)[:top]],
                "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=by)[:top]]}
