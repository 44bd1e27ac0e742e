"""Device kernel launches a unit (frame or step) in the traced span."""


def read(ctx):
    t = ctx["trace"]
    if not t.kernels or not ctx["units"]:
        return None
    return len(t.kernels) / ctx["units"]
