"""BENCHMARK.json keeps its rules, and every cell resolves its files by name."""

import importlib
import json
import math
import re
from pathlib import Path

import pytest

from portbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert all(_text(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_length_fits_a_full_check():
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|size|width|hidden|channels)$", k)


def test_workloads():
    pairs = set()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert 1 <= len(BENCH["workloads"]) <= 24 and four <= max(1, len(BENCH["workloads"]) // 4)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _text(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS - {"layer", "moves"} and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock",
                                                                       "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS - {"bound"} and "bound" not in m and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s" and _text(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    w, config, traffic = harness.resolve_cell(BENCH, cell, ROOT)
    assert config["name"] == w["config"]
    assert hasattr(harness.driver_module(traffic), "run")
    e2e = harness.cell_metrics(BENCH, cell, "end_to_end")
    layer = harness.cell_metrics(BENCH, cell, "per_layer")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names
        assert callable(harness.reader_module(m["name"]).read)
        if m["name"].startswith("roofline."):
            mod = importlib.import_module(f"portbench.roofline.{m['name'].split('.')[1]}")
            assert mod.KERNELS and mod.LAUNCHES_PER_CALL >= 1
    assert set(traffic["limits"]) and all(math.isfinite(v) for v in traffic["limits"].values())


@pytest.mark.parametrize("workload", sorted(p.stem for p in (ROOT / "portbench" / "traffic")
                                            .glob("*.json")))
def test_every_traffic_file_names_a_config_and_a_driver(workload):
    # Cells kept for later (PERF.md, Open questions) resolve as a cell does.
    w, config, traffic = harness.candidate_cell(BENCH, workload, ROOT)
    assert config["name"] == w["config"] and f"{w['config']}.{w['traffic']}" == workload
    assert hasattr(harness.driver_module(traffic), "run") and set(traffic["limits"])
