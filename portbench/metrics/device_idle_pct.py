"""Share of an untraced unit's time (the median host-clock time of the
units before the traced ones) in which the card ran no kernel, copy or
set: one less the device's busy time a unit in the CUDA-only trace over
that time, in percent.  The traced span itself runs slower than the
window (yardstick.profile), so it is not the denominator."""


def read(ctx):
    t, pace = ctx["trace"], ctx.get("unit_s")
    if not t.device or not ctx["units"] or not pace:
        return None
    return 100.0 * (1.0 - t.busy_s() / ctx["units"] / pace)
