"""Finds what a cell needs by name: BENCHMARK.json at the checkout's root,
and under portbench/ a configuration (configs/<name>.json), a traffic mix
(traffic/<name>.json), the loop that a mix names (loops/<loop>.py), a
reference (reference/<name>.py) and a per-layer metric's reader
(metrics/<name>.py, or metrics/<quantity>.py for a metric named
<quantity>.<suffix>: one reader serves the entries of one quantity that
move different end-to-end metrics).  A later cell adds files and entries;
nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT, c["file"])
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR, "traffic", name + ".json")


def module_path(kind: str, name: str) -> str:
    """portbench/<kind>/<name>.py; where it is absent and the name holds a
    dot, the file of the name before its last dot."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path) and "." in name:
        return module_path(kind, name.rsplit(".", 1)[0])
    return path


def module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (module_path finds it)."""
    path = module_path(kind, name)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, section: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") that a cell
    reports: those without a `workloads` key, and those that list it."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def config_path(*parts) -> str:
    return os.path.join(BENCH_DIR, "configs", *parts)
