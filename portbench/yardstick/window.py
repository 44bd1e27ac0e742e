"""The measured window: a closed loop of units (frames or steps), one in
flight, each timed by the host clock around its call."""

from __future__ import annotations

import contextlib
import time


def closed_loop(unit, seconds: float, tracer=None, period: int = 1) -> dict:
    """Call unit(i) for i = 0, 1, ... until `seconds` have passed, the
    traced units are done and the units make whole periods (a loop whose
    units cycle through `period` kinds of work ends on a whole cycle, so
    the kinds in a window's tail do not follow the host's pace); unit(i)
    returns a failure's text or None.  A tracer (yardstick.profile.Tracer)
    starts and stops around the units it traces, outside their times.
    Returns attempted, failed, the first failures, the window's seconds,
    each unit's seconds and the indices of the units traced for the device
    metrics."""
    end = tracer.end if tracer else 0
    times, failures = [], []
    start = time.perf_counter()
    i = 0
    while True:
        if tracer:
            tracer.before(i)
        scope = tracer.scope(i) if tracer else contextlib.nullcontext()
        a = time.perf_counter()
        with scope:
            err = unit(i)
        b = time.perf_counter()
        if tracer:
            tracer.after(i)
        times.append(b - a)
        if err:
            failures.append(err)
        i += 1
        if b - start >= seconds and i >= end and i % period == 0:
            break
    return dict(attempted=i, failed=len(failures), failures=failures[:5], window_s=b - start,
                times=times, traced=tracer.device_units if tracer else [])
