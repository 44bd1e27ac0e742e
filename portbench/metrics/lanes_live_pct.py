"""Share of the bounce levels' launched lanes that carried a live ray, in
percent: the live lanes summed over the levels of the frames traced with
CUDA activity alone (render_with_stats on the same views and seeds, outside
the trace: ctx["counters"]) over the `lanes` of the program's `rtt.level`
spans of the same frames (yardstick.program_spans), the width each level
was launched at."""

from yardstick import program_spans


def read(ctx):
    units = program_spans.device_units(ctx)
    counters = ctx.get("counters")
    if units is None or not counters or len(counters) != len(units):
        return None
    lanes = sum(r["counts"].get("lanes", 0) for r in program_spans.spans_named(units, "rtt.level"))
    if not lanes:
        return None
    return 100.0 * sum(lv["live"] for levels in counters for lv in levels) / lanes
