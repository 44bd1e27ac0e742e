"""The control comes out as not correct: the reference computed with TF32
operands (the precision below the float32-with-TF32-off that the
configurations state) in the program's place, at a size a CPU test can
hold, reads above each cell's limit.  The readings at the cells' own
sizes are taken on the card by calibrate.py (PERF.md)."""

import pytest

from yardstick import manifest

BENCH = manifest.benchmark()


def _session(cell, w, h, monkeypatch_traffic=None):
    c = manifest.cell(BENCH, cell)
    cfg = manifest.config(BENCH, c["config"])
    tr = manifest.traffic(c["traffic"])
    cfg["scene"]["render"] = {"resolution_x": w, "resolution_y": h}
    if tr["loop"] == "frames":
        tr.update(warmup=0, check=dict(tr["check"], pixels=w * h, frames=1))
    loop = manifest.module("loops", tr["loop"])
    return loop.Session(cfg, tr, 3000000029, "cpu"), manifest.module("reference", cfg["reference"])


@pytest.mark.parametrize("cell,w,h", [("flagship-frames", 48, 27), ("flagship-bvh-frames", 32, 18)])
def test_frames_control(cell, w, h):
    s, ref = _session(cell, w, h)
    s.kept = {0: None}
    checks = s.check(ref, tf32_program=True)
    assert any(v > lim for _, v, lim in checks), checks


def test_fit_control():
    s, ref = _session("flagship-fit", 32, 18)
    checks = s.check(ref, tf32_program=True)
    assert any(v > lim for _, v, lim in checks), checks
