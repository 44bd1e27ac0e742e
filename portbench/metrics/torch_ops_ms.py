"""Device milliseconds a unit (frame or step) in PyTorch's work: its
kernels (yardstick.profile.is_torch_kernel) and the copies and sets it
issues."""

from yardstick.profile import is_torch_kernel


def read(ctx):
    t = ctx["trace"]
    if not t.device or not ctx["units"]:
        return None
    return 1e3 * t.device_seconds(lambda c, n: c != "kernel" or is_torch_kernel(n)) / ctx["units"]
