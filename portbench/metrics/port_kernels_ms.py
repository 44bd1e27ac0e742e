"""Device milliseconds a unit (frame or step) in the port's own CUDA
kernels: every kernel of the traced span that is not PyTorch's
(yardstick.profile.is_torch_kernel: the at:: namespace and its libraries,
cub and thrust, told apart by demangled name)."""

from yardstick.profile import is_torch_kernel


def read(ctx):
    t = ctx["trace"]
    ks = [n for n, _, _ in t.kernels if not is_torch_kernel(n)]
    if not ks or not ctx["units"]:
        return None
    return 1e3 * t.device_seconds(lambda c, n: c == "kernel" and not is_torch_kernel(n)) / ctx["units"]
