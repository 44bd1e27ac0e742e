"""The program's own spans (ray_tracying_tpu_torch/spans.py), as the readers
of `program_span` and `program_counter` metrics take them.

The program records spans only while torch.profiler runs, so its buffer
holds the traced units in the order they ran (yardstick/profile.py): first
those traced with CUDA activity alone, which the device metrics read, then
the one traced with the host's operations.  A unit is one root span (a
frame or a fit step) and the spans that share its unit id.  A program
without the module, or one that recorded fewer roots than the trace has
units, gives None and never raises, so that a reader leaves its metric out
of the line."""

from __future__ import annotations


def device_units(ctx) -> list | None:
    """[the records of each unit] of the first ctx["units"] roots, or None."""
    try:
        from ray_tracying_tpu_torch import spans
    except ImportError:
        return None
    recs = spans.records()
    roots = sorted((r for r in recs if r["parent"] is None and r["name"].startswith("rtt.")),
                   key=lambda r: r["start_ns"])
    n = ctx["units"]
    if not n or len(roots) < n:
        return None
    units = {r["unit"]: [] for r in roots[:n]}
    for r in recs:
        if r["unit"] in units:
            units[r["unit"]].append(r)
    return list(units.values())


def spans_named(units: list, name: str):
    """Each record of `name` in `units`."""
    return (r for u in units for r in u if r["name"] == name)
