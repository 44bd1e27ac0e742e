"""Host milliseconds a unit (frame or step) inside the program's `rtt.read`
spans, on the program's own clock, in the units traced with CUDA activity
alone (yardstick.program_spans): the time the host is blocked on the card.
The profiler records no host operation there, so it does not stretch it."""

from yardstick import program_spans


def read(ctx):
    units = program_spans.device_units(ctx)
    if units is None:
        return None
    ns = sum(r["end_ns"] - r["start_ns"] for r in program_spans.spans_named(units, "rtt.read"))
    return 1e-6 * ns / len(units)
