"""Device-to-host reads a unit (frame or step): the program's `rtt.read`
spans in each unit traced with CUDA activity alone (yardstick.program_spans),
averaged.  Each read blocks the host until the card has run everything
queued before it."""

from yardstick import program_spans


def read(ctx):
    units = program_spans.device_units(ctx)
    if units is None:
        return None
    return sum(1 for _ in program_spans.spans_named(units, "rtt.read")) / len(units)
