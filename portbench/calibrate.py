"""Readings that a cell's limits are set from, in one process on the card:
the program's compared numbers over many seeds, and the control's (the
reference computed with TF32 operands in the program's place) over a few.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 --seconds 2

Each seed runs the cell's loop for --seconds as a run does, then its
comparison.  The benchmark's own runs never run this.  Prints one JSON line
a reading."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--fault", default=None, help="plant a fault of faults.py in the program")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    import torch

    import numpy as np

    from yardstick import compare, manifest, seeds

    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    loop = manifest.module("loops", traffic["loop"])
    reference = manifest.module("reference", cfg["reference"])
    device = torch.device(device or "cuda:0")
    if args.fault:
        import faults

        getattr(faults, args.fault)(faults.Patches())
    out = []
    session = None
    for k in range(args.seeds + args.control):
        seed = args.first_seed + 7919 * k
        control = k >= args.seeds
        t = time.time()
        if session is None or traffic["loop"] != "frames":
            session = loop.Session(cfg, traffic, seed, device)
        else:
            session.seed, session.kept = seed, {}
            session.px, session.py = compare.sample_pixels(
                session.width, session.height, traffic["check"]["pixels"],
                np.random.default_rng(seeds.derive(seed, "pixels")))
        w = session.window(args.seconds)
        checks = session.check(reference, tf32_program=control)
        line = {"cell": cell["name"], "seed": seed, "kind": "control" if control else (args.fault or "program"),
                "failed": w["failed"], "units": w["attempted"], "seconds": time.time() - t,
                "readings": {n: v for n, v, _ in checks}}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
