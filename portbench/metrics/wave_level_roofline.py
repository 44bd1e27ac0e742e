"""The fused bounce level's share of its roofline: the least time its
bytes need at the card's HBM peak (yardstick.bytes: each live lane's queue
rows read and output rows written, a glossy hit's fuzz rows, the table once
a launch) over the device time of the wave_level kernels of the traced
frames.  Live and hit counts per level come from render_with_stats on the
same views and seeds, outside the traced span.  Bound by bytes only: the
tests a culled search needs depend on the cull that implements it."""

from yardstick import bytes as B


def read(ctx):
    t = ctx["trace"]
    waves = [(n, dur) for n, _, dur in t.kernels if "wave_level" in n]
    if not waves or not ctx["counters"] or not sum(d for _, d in waves):
        return None
    f = ctx["facts"]
    need = sum(B.level_bytes(lv["live"], lv["hits"], f["glossy"], f["motion"])
               for levels in ctx["counters"] for lv in levels)
    need += len(waves) * B.table_bytes(f["n_geoms"], f["n_lights"])
    return 100.0 * B.roofline_s(need) / (sum(d for _, d in waves) * 1e-6)
