"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json) names a configuration (portbench/configs/) and a
traffic mix (portbench/traffic/); the mix names the loop that drives the
program (portbench/loops/).  Set-up loads the scene and warms up every
shape the window uses; the window runs the loop for --seconds; then the
process's device memory is read, the program's state freed, and frames or
steps drawn from the seed are compared with the plain reference
(portbench/reference/).  setup_s runs from the process's start to the
window's start, less the seconds the reference takes in set-up (the
fit's target, the loop's phase "reference").  --trace 1 traces a few
units of the window with torch.profiler (yardstick/profile.py) and
reports the per-layer metrics (portbench/metrics/) instead of the
end-to-end ones, with the traced units' times beside the untraced ones'.  Needs CUDA and as many cards as the cell
asks for; exits non-zero without them.
"""

from __future__ import annotations

import os
import time

_T_IMPORT = time.time()


def _process_start() -> float:
    """Wall time at which this process started (Linux), else the time this
    module was first run."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def _steady_host():
    """One host thread for PyTorch's and the BLAS's pools, and the process
    on two cores of those it may use, past the first two: whole runs
    otherwise drift by several percent with the cores the scheduler gives
    them.  Acts on this process only; set before numpy or torch start their
    threads."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 4:
        os.sched_setaffinity(0, cpus[2:4])

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

GIB = float(1 << 30)


def _fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _unit_ms(w: dict, tracer) -> dict:
    """Median ms a unit: untraced (the units before the traced ones, past
    the first), traced for the device metrics, and the one traced with the
    host's operations."""
    import statistics

    t = w["times"]
    return {"untraced": 1e3 * statistics.median(t[i] for i in tracer.pace_units) if tracer.pace_units else None,
            "device_traced": 1e3 * statistics.median(t[i] for i in tracer.device_units),
            "host_traced": 1e3 * t[tracer.host_unit]}


def main(argv=None, device=None) -> int:
    """device: None runs on the card (and fails without one); a test passes
    "cpu" to drive the rest of a run on the program's CPU path."""
    t0 = _process_start()
    if device is None:
        _steady_host()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]  # the yardstick, the program
    from yardstick import guard, manifest
    from yardstick.profile import Tracer

    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            _fail(f"the cell needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda:0"
    device = torch.device(device)
    cuda = device.type == "cuda"
    loop = manifest.module("loops", traffic["loop"])
    reference = manifest.module("reference", cfg["reference"])

    t_ready = time.time()
    session = loop.Session(cfg, traffic, args.seed, device)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t0 - session.phases.get("reference", 0.0)
    print(f"portbench: set-up {setup_s:.2f} s: {t_ready - t0:.2f} s to import and find the card, "
          f"{time.time() - t_ready:.2f} s to load and warm up "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in session.phases.items())})", file=sys.stderr)

    tracer = Tracer(**traffic["trace"]) if args.trace else None
    w = session.window(args.seconds, tracer)
    if cuda:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak)}
    else:
        window_peak = 0
        device_info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}

    if args.trace:
        trace = tracer.read()
        unit_ms = _unit_ms(w, tracer)
        ctx = {"trace": trace, "units": trace.units, "counters": session.counters(),
               "facts": session.facts,
               "unit_s": unit_ms["untraced"] * 1e-3 if unit_ms["untraced"] else None}
        metrics = {}
        for m in manifest.metrics_of(bench, cell["name"], "per_layer"):
            value = manifest.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
    else:
        e2e = dict(session.end_to_end(w), peak_mem_gib=window_peak / GIB, setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_of(bench, cell["name"], "end_to_end")}

    session.release()
    t_check = time.time()
    checks = session.check(reference)
    t_check = time.time() - t_check
    found = guard.loaded_forbidden()
    if found:
        _fail("the process loaded JAX or the JAX package: " + ", ".join(found), 3)

    # a reading that is not a finite number (a NaN loss) is printed as null and fails
    checks = [(name, v if math.isfinite(v) else None, lim) for name, v, lim in checks]
    correct = w["failed"] == 0 and all(v is not None and v <= lim for _, v, lim in checks)
    ms = sorted(t * 1e3 for t in w["times"])
    print(f"portbench: {w['attempted']} units in {w['window_s']:.3f} s; ms a unit: min {ms[0]:.2f}, "
          f"median {ms[len(ms) // 2]:.2f}, max {ms[-1]:.2f}", file=sys.stderr)
    for msg in w["failures"]:
        print(f"portbench: failed: {msg}", file=sys.stderr)
    power = _power_limit()
    result = {"correct": correct, "attempted": w["attempted"], "failed": w["failed"],
              "metrics": metrics, "device": device_info, "power": power}
    if args.trace:
        result["breakdown"] = trace.breakdown()
        result["unit_ms"] = unit_ms
        print("portbench: ms a unit, median: " + ", ".join(
            f"{k} {v!r}" for k, v in result["unit_ms"].items()), file=sys.stderr)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    print(f"portbench: {cell['name']} seed {args.seed} on {power}; "
          f"the comparison took {t_check:.1f} s", file=sys.stderr)
    for name, v, lim in checks:
        print(f"portbench: check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
