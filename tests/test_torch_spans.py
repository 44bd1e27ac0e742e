"""The port's spans and counters (ray_tracying_tpu_torch/spans.py): nothing
recorded with the profiler off; recorded (a frame under a CPU profiler, the
costlier cases with the recorder's flag forced on), a closed tree of spans
a frame or a fit step with one unit id through it, the reads it makes and
the widths its levels run at; the trace's clock, the buffer's cap and the
unit of a span opened on another thread."""

import collections
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ray_tracying_tpu_torch as rt
from ray_tracying_tpu_torch import spans
from ray_tracying_tpu_torch.render import pipeline
from ray_tracying_tpu_torch.render.integrator import shrink_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX = os.path.join(REPO, "golden", "Textures")
# One shrink point at the CPU size: a tile of 2,304 lanes runs levels 0-1
# at its width and 2-10 at 2,048 lanes (a stage's width is a multiple of
# 2,048 lanes, so a narrower tile has no shrink point).
SHRINK = ((2, 2),)
# The calls that bring a tensor's value to the host.
READS = (
    [(torch.Tensor, n) for n in ("cpu", "item", "tolist", "__int__", "__float__", "__bool__")]
    + [(torch, "nonzero")]
)
PORT = os.path.dirname(rt.__file__)


def _flagship(w, h):
    scene = rt.load_scene(os.path.join(REPO, "golden", "ASCII", "scene.json"),
                          textures_dir=TEX, device="cpu")
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, resolution=(w, h)))


def _port_read():
    """Whether the caller of a read is the port's own code outside a
    kernel's plain version (`*_plain`, which reads its table on the host
    where the card runs the kernel)."""
    f = sys._getframe(2)
    if not f.f_code.co_filename.startswith(PORT):
        return False
    while f is not None:
        if f.f_code.co_name.endswith("_plain"):
            return False
        f = f.f_back
    return True


def _recorded(run, profiled):
    """run() recorded -> (its result, the records, the port's host reads as
    (call, inside an rtt.read span)).  profiled: under a CPU profiler, as a
    user records; else with the recorder's flag forced on, which records
    the same spans without the profiler's cost a CPU operation."""
    reads = []
    spans.clear()
    with pytest.MonkeyPatch.context() as mp:
        if not profiled:
            mp.setattr(spans, "_recording", lambda: True)
        for owner, name in READS:
            real = getattr(owner, name)

            def counted(*a, _name=name, _real=real, **k):
                if _port_read():
                    st = spans._BUF.stack()
                    reads.append((_name, bool(st) and st[-1].name == "rtt.read"))
                return _real(*a, **k)

            mp.setattr(owner, name, counted)
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
            out = run()
    recs = spans.records()
    spans.clear()
    return out, recs, reads


@pytest.fixture(scope="module")
def runs():
    """Each case recorded once: a small fused flagship frame under a CPU
    profiler ("profiled"), a fused one in two tiles with a shrink point each
    ("fused"), a general-path (use_bvh) frame and one fit step; the frames
    also rendered with the profiler off."""
    out = {}
    cases = {
        "profiled": (_flagship(16, 9), rt.RenderOptions(samples_sqrt=1), True),
        "fused": (_flagship(32, 36), rt.RenderOptions(samples_sqrt=2, max_rays_per_pass=32 * 4 * 18),
                  False),
        "general": (_flagship(16, 9), rt.RenderOptions(samples_sqrt=1, use_bvh=True), False),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "tile_shrink", lambda n, spp: SHRINK if n > 2048 else ())
        for name, (scene, opts, profiled) in cases.items():
            def frame(scene=scene, opts=opts):
                return rt.render_to_srgb_u8(scene, opts, torch.Generator().manual_seed(11),
                                            device="cpu")

            off = frame()
            on, recs, reads = _recorded(frame, profiled)
            out[name] = dict(off=off, on=on, recs=recs, reads=reads)

    scene = _flagship(16, 9)
    target = torch.full((9, 16, 3), 0.3)
    _, recs, reads = _recorded(lambda: rt.fit(
        scene, target, ["materials.diffuse"], steps=1, seed=3, device="cpu",
        opts=rt.RenderOptions(samples_sqrt=1)), False)
    out["fit"] = dict(recs=recs, reads=reads)
    return out


def test_nothing_recorded_with_the_profiler_off(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: entered.append(a))
    spans.clear()
    rt.render_to_srgb_u8(_flagship(16, 9), rt.RenderOptions(samples_sqrt=1),
                         torch.Generator().manual_seed(1), device="cpu")
    with spans.span("rtt.x", lanes=1) as s:
        s.add(kept=2)
    assert spans.records() == [] and spans.dropped() == 0 and entered == []


@pytest.mark.parametrize("case", ["profiled", "fused", "general"])
def test_frames_are_byte_equal_with_recording_on_and_off(runs, case):
    r = runs[case]
    assert r["on"].dtype == np.uint8 and np.array_equal(r["on"], r["off"])


@pytest.mark.parametrize("case,root", [("profiled", "rtt.frame"), ("fused", "rtt.frame"),
                                       ("general", "rtt.frame"), ("fit", "rtt.step")])
def test_a_unit_is_one_closed_tree(runs, case, root):
    recs = runs[case]["recs"]
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == [root]
    assert {r["unit"] for r in recs} == {roots[0]["id"]}
    for r in recs:
        assert r["name"].startswith("rtt.") and r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
    assert all(v >= 0 for v in spans.self_ns(recs).values())
    names = collections.Counter(r["name"] for r in recs)
    expected = {
        "profiled": {"rtt.prep", "rtt.tile", "rtt.rays", "rtt.level", "rtt.fuzz", "rtt.post",
                     "rtt.read"},
        "fused": {"rtt.prep", "rtt.tile", "rtt.rays", "rtt.level", "rtt.fuzz", "rtt.shrink",
                  "rtt.post", "rtt.read"},
        "general": {"rtt.prep", "rtt.tile", "rtt.rays", "rtt.level", "rtt.hit",
                    "rtt.materials", "rtt.shade", "rtt.spawn", "rtt.post", "rtt.read"},
        "fit": {"rtt.forward", "rtt.backward", "rtt.adam", "rtt.rays", "rtt.level",
                "rtt.level_backward", "rtt.level_backward.recompute",
                "rtt.level_backward.grad", "rtt.read"},
    }[case]
    assert expected <= set(names), names
    if case == "fit":
        assert names["rtt.level_backward"] == names["rtt.level"] == 11


@pytest.mark.parametrize("case", ["profiled", "fused", "general", "fit"])
def test_read_spans_are_the_reads_made(runs, case):
    """Every value brought to the host outside a kernel's plain version is
    read inside one rtt.read span, and each rtt.read span reads once."""
    r = runs[case]
    recs, reads = r["recs"], r["reads"]
    assert reads and all(inside for _, inside in reads), reads
    assert sum(x["name"] == "rtt.read" for x in recs) == len(reads)
    what = collections.Counter(x["counts"]["what"] for x in recs if x["name"] == "rtt.read")
    if case == "fused":  # two tiles, a shrink point each
        assert what["shrink live lanes"] == 2 and what["image"] == what["dropped"] == 1
    if case == "fit":
        assert what["loss"] == what["dropped"] == 1


def test_level_lanes_are_the_shrink_plans_widths(runs):
    r = runs["fused"]
    tiles = [x for x in r["recs"] if x["name"] == "rtt.tile"]
    levels = sorted((x for x in r["recs"] if x["name"] == "rtt.level"), key=lambda x: x["start_ns"])
    assert [t["counts"]["lanes"] for t in tiles] == [2304, 2304] and len(levels) == 22
    bounds, widths = shrink_plan(2304, 11, SHRINK)
    assert widths == [4096, 2048]
    want = [2304 if s == 0 else widths[s]
            for s in range(len(widths)) for _ in range(bounds[s], bounds[s + 1])]
    assert [x["counts"]["depth"] for x in levels] == list(range(11)) * 2
    assert [x["counts"]["lanes"] for x in levels] == want * 2
    shrinks = [x["counts"] for x in r["recs"] if x["name"] == "rtt.shrink"]
    assert len(shrinks) == 2 and all(c["dropped"] == 0 and c["kept"] > 0 for c in shrinks)


def test_stamps_are_the_traces_clock(tmp_path):
    """Each span's Unix-ns stamps lie within 1 ms of its record_function
    event in the profiler's trace (baseTimeNanoseconds plus ts in us)."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("rtt.frame", rays=4):
            for i in range(3):
                with spans.span("rtt.level", depth=i, lanes=4):
                    torch.ones(64).cumsum(0)
                    time.sleep(0.002)
                with spans.read("image"):
                    torch.ones(4).sum().item()
    recs = spans.records()
    spans.clear()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    events = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("rtt."):
            events[e["name"]].append((base + float(e["ts"]) * 1e3, float(e["dur"]) * 1e3))
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r["name"]].append(r)
    assert {k: len(v) for k, v in events.items()} == {"rtt.frame": 1, "rtt.level": 3, "rtt.read": 3}
    for name, evs in events.items():
        rs = sorted(by_name[name], key=lambda r: r["start_ns"])
        assert len(evs) == len(rs)
        for (ts, dur), r in zip(sorted(evs), rs):
            assert abs(ts - r["start_ns"]) < 1e6 and abs(ts + dur - r["end_ns"]) < 1e6


def test_the_buffers_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 5)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("rtt.frame", rays=8):
            for i in range(7):
                with spans.read(f"r{i}"):
                    pass
    recs = spans.records()
    assert len(recs) == 5 and spans.dropped() == 3
    assert [r["counts"]["what"] for r in recs] == ["r0", "r1", "r2", "r3", "r4"]
    recs[0]["counts"]["what"] = "changed"
    assert spans.records()[0]["counts"]["what"] == "r0"  # a copy
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_spans_of_another_thread_keep_the_unit(monkeypatch):
    """A span opened on a thread with no span open (autograd's device
    thread in a backward) joins the open root's unit, under the innermost
    span open on the root's thread.  A plain thread does not see the
    profiler's thread-local state, so the flag is forced here."""
    monkeypatch.setattr(spans, "_recording", lambda: True)
    spans.clear()
    with spans.span("rtt.step") as root:
        with spans.span("rtt.backward") as bwd:
            def backward():
                with spans.span("rtt.level_backward"):
                    pass

            t = threading.Thread(target=backward)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    with spans.span("rtt.step") as root2:
        pass
    recs = {r["name"]: r for r in spans.records() if r["id"] != root2.id}
    spans.clear()
    lb = recs["rtt.level_backward"]
    assert lb["unit"] == root.id and lb["parent"] == bwd.id
    assert root2.unit == root2.id != root.id
