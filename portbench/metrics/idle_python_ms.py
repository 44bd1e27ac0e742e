"""Device-idle milliseconds in the unit traced with the host's operations
in which the innermost host event at the gap's midpoint (Trace.hosts_at, as
`breakdown` names its idle gaps) is one of the program's `rtt.*` spans: the
port's own Python with no aten operation or CUDA call running while the
card waits.  None where the trace holds no `rtt.*` span."""


def read(ctx):
    host = getattr(ctx["trace"], "host_trace", None)
    if host is None or not host.units or not any(n.startswith("rtt.") for n, _, _ in host.host):
        return None
    gaps = host.gaps()
    names = host.hosts_at([(a + b) / 2 for a, b in gaps])
    return 1e-3 * sum(b - a for (a, b), n in zip(gaps, names) if n.startswith("rtt.")) / host.units
