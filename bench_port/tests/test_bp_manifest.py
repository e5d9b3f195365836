"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every file it names found under bench_port/."""

import json
import os
import re

import pytest

from bp_tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench_port/run.py"]
    assert bench["paths"] == ["bench_port"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_units_and_keys(bench, section):
    seen = set()
    for entry in bench[section]:
        extra = set(entry) - KEYS[section]
        assert set(entry) >= KEYS[section], entry
        assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set()), extra
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] and "\t" not in entry[text]
        for key in entry.get("reduced", []):
            assert NAME.match(key)
            assert not re.search(r"(Size|_dim|_rank|Factor|nHead)$", key), key


def test_cells_and_metrics_resolve(bench):
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        assert c["file"].startswith("bench_port/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        with open(os.path.join(BENCH, "cells", w["name"] + ".json")) as f:
            assert os.path.exists(os.path.join(BENCH, "drivers", json.load(f)["driver"] + ".py"))
        reports = [m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        layers = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layers, w["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
