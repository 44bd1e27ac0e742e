"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""

import json
import os
import re

import pytest

from yardstick import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"].startswith("portbench/") and os.path.isfile(os.path.join(manifest.ROOT, cfg["file"]))
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    body = manifest.config(BENCH, cfg["name"])
    assert os.path.isfile(os.path.join(manifest.BENCH_DIR, "reference", body["reference"] + ".py"))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    cfg = manifest.config(BENCH, cell["config"])
    tr = manifest.traffic(cell["traffic"])
    assert os.path.isfile(os.path.join(manifest.BENCH_DIR, "loops", tr["loop"] + ".py"))
    assert set(cfg["check"][tr["loop"]]["limits"])
    e2e = {m["name"] for m in manifest.metrics_of(BENCH, cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(BENCH, cell["name"], "per_layer")
    for m in manifest.metrics_of(BENCH, cell["name"], "per_layer"):
        assert os.path.isfile(manifest.module_path("metrics", m["name"]))


def test_pairs_appear_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_setup_s_everywhere():
    m = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in m and m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m.get("workloads", CELLS)) <= set(moved.get("workloads", CELLS))
    if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_layers_named_in_perf_md():
    with open(os.path.join(manifest.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"`{layer}`" in perf, layer


def test_reader_of_a_quantity_serves_its_suffixed_entries():
    path = manifest.module_path("metrics", "device_idle_pct.fit")
    assert path == os.path.join(manifest.BENCH_DIR, "metrics", "device_idle_pct.py")
    assert manifest.module_path("metrics", "wave_level_roofline").endswith("wave_level_roofline.py")


def test_config_files_are_json_named_from_names():
    for root, _, files in os.walk(manifest.BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), manifest.BENCH_DIR)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    for c in BENCH["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            assert isinstance(json.load(f), dict)
