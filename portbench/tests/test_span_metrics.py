"""The readers of the program's spans and counters (metrics/host_reads.py,
host_wait_ms.py, idle_python_ms.py, lanes_live_pct.py): each gives its
value on a synthetic trace and buffer, None where the program recorded no
`rtt.` span or lacks the module that records them (the parent's program),
never an error, and reads a trace the size of a general-path frame's in
well under a second.  One CPU frame of the program, recorded as the
benchmark's host-traced unit is, gives every reader a number."""

import sys
import time

import pytest

from yardstick import manifest, profile
from yardstick.profile import Trace

QUANTITIES = ["host_reads", "host_wait_ms", "idle_python_ms", "lanes_live_pct"]
READERS = {q: manifest.module("metrics", q) for q in QUANTITIES}
MS = 1_000_000  # ns


def _records(units=3, reads=(2, 4, 3), host_reads=10, levels=(1000, 1000, 1000)):
    """Units of the device stretch (reads of 1 ms, levels of `levels` lanes
    in all), then the host-traced unit with `host_reads` reads."""
    recs, nid, t = [], 0, 0
    for u in range(units + 1):
        nid += 1
        root = nid
        recs.append(dict(name="rtt.frame", start_ns=t, end_ns=t + 50 * MS, id=root, parent=None,
                         unit=root, counts={"rays": 10}))
        n_reads = reads[u] if u < units else host_reads
        for k in range(n_reads):
            nid += 1
            recs.append(dict(name="rtt.read", start_ns=t + k * 2 * MS, end_ns=t + (k * 2 + 1) * MS,
                             id=nid, parent=root, unit=root, counts={"what": "x"}))
        for w in (levels[u] // 2, levels[u] - levels[u] // 2) if u < units else (7, 7):
            nid += 1
            recs.append(dict(name="rtt.level", start_ns=t + 30 * MS, end_ns=t + 31 * MS, id=nid,
                             parent=root, unit=root, counts={"depth": 0, "lanes": w}))
        t += 100 * MS
    return recs


def _trace(host_spans=True, units=3):
    """A device trace of `units` units whose host-traced unit idles 20 us
    inside an rtt.shrink span and 30 us inside aten::mul."""
    dev = [("kernel", "k", 0.0, 10.0), ("kernel", "k", 30.0, 30.0), ("kernel", "k", 90.0, 10.0)]
    t = Trace(0.0, 100.0, dev, [], units)
    host = [("aten::mul", 70.0, 10.0), ("cudaLaunchKernel", 1.0, 2.0)]
    if host_spans:
        host += [("rtt.frame", 0.0, 100.0), ("rtt.shrink", 15.0, 10.0)]
    t.host_trace = Trace(0.0, 100.0, dev, host, 1)
    return t


def _ctx(trace, units=3, counters=None):
    if counters is None:
        counters = [[{"live": 200, "hits": 1}, {"live": 50, "hits": 1}]] * units
    return {"trace": trace, "units": units, "counters": counters, "facts": {}, "unit_s": 0.1}


@pytest.fixture
def buffer(monkeypatch):
    """The program's spans module, its records() replaced by a setter's."""
    from ray_tracying_tpu_torch import spans

    held = []
    monkeypatch.setattr(spans, "records", lambda: [dict(r) for r in held])
    return held


EXPECTED = {
    "host_reads": 3.0,                      # (2 + 4 + 3) / 3 units
    "host_wait_ms": 3.0,                    # 9 reads of 1 ms over 3 units
    "idle_python_ms": 0.02,                 # the 20 us gap inside rtt.shrink
    "lanes_live_pct": 25.0,                 # 3 x 250 live over 3 x 1000 lanes
}


@pytest.mark.parametrize("q", QUANTITIES)
def test_synthetic_trace_and_buffer(buffer, q):
    buffer.extend(_records())
    assert READERS[q].read(_ctx(_trace())) == pytest.approx(EXPECTED[q])


@pytest.mark.parametrize("q", QUANTITIES)
def test_no_rtt_spans_give_none(buffer, q):
    assert READERS[q].read(_ctx(_trace(host_spans=False))) is None


@pytest.mark.parametrize("q", QUANTITIES)
def test_the_parents_program_gives_none(monkeypatch, q):
    """The parent's program has no spans module: the import fails, the
    reader returns None and raises nothing."""
    import ray_tracying_tpu_torch

    monkeypatch.delattr(ray_tracying_tpu_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "ray_tracying_tpu_torch.spans", None)
    with pytest.raises(ImportError):
        from ray_tracying_tpu_torch import spans  # noqa: F401
    assert READERS[q].read(_ctx(_trace(host_spans=False))) is None


@pytest.mark.parametrize("q", ["host_reads", "host_wait_ms", "lanes_live_pct"])
def test_fewer_roots_than_units_give_none(buffer, q):
    buffer.extend(_records(units=1, reads=(2,), levels=(1000,)))
    assert READERS[q].read(_ctx(_trace(), units=3)) is None


def test_lanes_live_pct_without_counters_is_none(buffer):
    buffer.extend(_records())
    assert READERS["lanes_live_pct"].read(_ctx(_trace(), counters=[])) is None


@pytest.mark.parametrize("q", QUANTITIES)
def test_readers_fit_a_general_path_trace(buffer, q):
    """30,000 kernels and 5,000 spans, read in under a second."""
    n_k, n_s = 30_000, 5_000
    dev = [("kernel", f"k{i % 50}", 10.0 * i, 6.0) for i in range(n_k)]
    host = [("cudaLaunchKernel", 10.0 * i + 1, 3.0) for i in range(n_k)]
    host += [("rtt.frame", 0.0, 10.0 * n_k)]
    host += [("rtt.level" if i % 2 else "rtt.read", 60.0 * i + 7, 2.5) for i in range(n_s - 1)]
    trace = Trace(0.0, 10.0 * n_k, dev, [], 2)
    trace.host_trace = Trace(0.0, 10.0 * n_k, dev, host, 1)
    per_unit = n_s // 3
    buffer.extend(_records(units=2, reads=(per_unit, per_unit), host_reads=per_unit))
    t = time.perf_counter()
    value = READERS[q].read(_ctx(trace, units=2))
    assert time.perf_counter() - t < 1.0 and value is not None


def test_a_recorded_cpu_frame_gives_every_reader_a_number(monkeypatch):
    """The program's CPU path, one small flagship frame traced as the
    benchmark traces its host unit (CPU activity, the window and unit
    annotations): its own buffer and trace feed every reader."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    import ray_tracying_tpu_torch as rt
    from ray_tracying_tpu_torch import spans

    bench = manifest.benchmark()
    cfg = manifest.config(bench, "flagship")
    cfg["scene"]["render"] = {"resolution_x": 16, "resolution_y": 9}
    from loops.frames import scene_dict

    scene = rt.load_scene_dict(scene_dict(cfg), textures_dir=manifest.config_path(cfg["textures"]),
                               device="cpu")
    opts = rt.RenderOptions(samples_sqrt=1)
    spans.clear()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(profile.WINDOW):
            with record_function(profile.UNIT):
                img = rt.render_to_srgb_u8(scene, opts, torch.Generator().manual_seed(2), device="cpu")
    trace = Trace.annotated(profile._events(prof))
    holder = Trace(trace.t0, trace.t1, [], [], 1)
    holder.host_trace = trace
    _, st = rt.render_with_stats(scene, opts, torch.Generator().manual_seed(2), device="cpu")
    values = {q: READERS[q].read(_ctx(holder, units=1, counters=[st["levels"]])) for q in QUANTITIES}
    spans.clear()
    assert img.dtype == np.uint8
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["host_reads"] == 6  # the windows' table, three geom box reads, image, dropped
    assert 0 < values["lanes_live_pct"] <= 100
