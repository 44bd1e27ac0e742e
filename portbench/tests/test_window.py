"""The window's stopping rule, on a fake unit and a fake clock: it ends
once its seconds have passed, the traced units are done and the count of
units is a whole number of periods."""

import contextlib

import pytest

from yardstick import window


class _Clock:
    """perf_counter that a unit moves on by its own seconds."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Tracer:
    def __init__(self, end):
        self.end, self.device_units = end, [end - 2]
        self.calls = []

    def before(self, i):
        self.calls.append(("before", i))

    def scope(self, i):
        return contextlib.nullcontext()

    def after(self, i):
        self.calls.append(("after", i))


def _run(monkeypatch, seconds, period, unit_s, tracer=None):
    clock = _Clock()
    monkeypatch.setattr(window.time, "perf_counter", clock)
    done = []

    def unit(i):
        clock.t += unit_s[i % len(unit_s)]
        done.append(i)
        return "bad" if i == 3 else None

    return window.closed_loop(unit, seconds, tracer, period=period), done


@pytest.mark.parametrize("seconds, period, unit_s, attempted", [
    (1.0, 1, [0.25], 4),              # the unit that reaches the seconds ends it
    (1.1, 1, [0.25], 5),
    (1.1, 8, [0.25], 8),              # ... then on to the end of the period
    (2.0, 8, [0.25], 8),              # seconds reached on a whole period: no more
    (2.25, 8, [0.25], 16),            # a unit past a whole period: a whole period more
    (0.5, 3, [0.25, 0.5, 1.0], 3),    # units of unequal seconds, a cycle of three kinds
    (0.0, 8, [0.25], 8),
])
def test_the_window_ends_on_a_whole_period(monkeypatch, seconds, period, unit_s, attempted):
    w, done = _run(monkeypatch, seconds, period, unit_s)
    assert w["attempted"] == attempted == len(done) and done == list(range(attempted))
    assert w["window_s"] == pytest.approx(sum(unit_s[i % len(unit_s)] for i in range(attempted)))
    assert len(w["times"]) == attempted and w["failed"] == (1 if attempted > 3 else 0)


def test_traced_units_come_before_the_period(monkeypatch):
    """Traced units past the seconds keep the window open; it then runs on
    to the end of the period."""
    tracer = _Tracer(end=11)
    w, _ = _run(monkeypatch, 1.0, 8, [0.25], tracer)
    assert w["attempted"] == 16 and w["traced"] == [9]
    assert tracer.calls[:2] == [("before", 0), ("after", 0)] and len(tracer.calls) == 32
