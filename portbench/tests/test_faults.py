"""Each fault a cell can have, planted under the timed path, comes out as
not correct: a run on the program's CPU path at a small size (the look for
a card skipped), with the fault, against the same run without it.

Frames: half of each pixel's samples left out and the mean taken over the
rest; a frame returned again (the previous view's); a frame's bytes
altered where they are produced.  Fit steps: a step that leaves its
parameters unchanged; half of the image left out of the loss, the mean
taken over the rest; the loss altered where it is produced.  No cell has an
exchange between cards."""

import json

import pytest

import faults
import run
from yardstick import manifest

W, H = 16, 9


@pytest.fixture
def small(monkeypatch):
    """Cells at W x H: every pixel compared, a wide pan so that views differ
    at this size."""
    cfg0, tr0 = manifest.config, manifest.traffic

    def cfg(bench, name):
        c = cfg0(bench, name)
        c["scene"]["render"] = {"resolution_x": W, "resolution_y": H}
        return c

    def tr(name):
        t = tr0(name)
        if t["loop"] == "frames":
            t.update(warmup=1, pan_degrees=20.0, check=dict(t["check"], pixels=W * H, frames=2))
        return t

    monkeypatch.setattr(manifest, "config", cfg)
    monkeypatch.setattr(manifest, "traffic", tr)


def _run(capsys, cell, seconds, seed=3000000023):
    run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
             device="cpu")
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


_SOUND = {}


def _sound(capsys, cell, seconds):
    """The run without a fault, once a cell."""
    if cell not in _SOUND:
        _SOUND[cell] = _run(capsys, cell, seconds)
    return _SOUND[cell]


def _worst_excess(res):
    return max(c["value"] - c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", faults.FRAMES, ids=lambda f: f.__name__)
def test_frame_faults(small, capsys, monkeypatch, fault):
    sound = _sound(capsys, "flagship-frames", 10.0)
    fault(monkeypatch)
    bad = _run(capsys, "flagship-frames", 10.0)
    assert sound["failed"] == 0 and bad["attempted"] >= (3 if fault is faults.frame_again else 1)
    assert bad["correct"] is False
    assert _worst_excess(bad) > _worst_excess(sound) + 0.5


@pytest.mark.parametrize("fault", faults.FIT, ids=lambda f: f.__name__)
def test_fit_faults(small, capsys, monkeypatch, fault):
    sound = _sound(capsys, "flagship-fit", 0.5)
    fault(monkeypatch)
    bad = _run(capsys, "flagship-fit", 0.5)
    assert sound["failed"] == 0
    assert bad["correct"] is False
    assert _worst_excess(bad) > _worst_excess(sound) + 0.2
