"""BENCHMARK.json against the benchmark's contract, and discovery by
name: every configuration, traffic mix, limit file and metric reader a
cell names is found under ``slambench/``."""

import json
import re
from pathlib import Path

import pytest

from slambench import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line_ok(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(line_ok(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        for e in BENCH[kind]:
            extra = {"workloads"} if kind in ("end_to_end",
                                             "per_layer") else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]


def test_configs():
    for c in BENCH["configs"]:
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["source"].startswith("https://")
        f = ROOT / c["file"]
        assert c["file"].startswith("slambench/") and f.is_file()
        data = json.loads(f.read_text())
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells():
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell, config, traffic, limits = bench_run.cell_files(BENCH,
                                                            w["name"])
        assert config["system"] and traffic["entry"] and limits
        e2e = bench_run.metrics_of(BENCH, w["name"], False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert bench_run.metrics_of(BENCH, w["name"], True)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m.get("workloads", sorted(cells)):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(bench_run.reader(metric))


def test_files_are_named_from_names():
    for f in (ROOT / "slambench").rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
