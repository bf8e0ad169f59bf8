"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name and readable."""

import json
import os
import re

import pytest

from benchmark.harness import HERE, ROOT, benchmark_spec, load_json, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    spec = benchmark_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert spec["paths"] == ["benchmark"] and isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    assert all(_line(w) for w in spec["command"]) and len(spec["command"]) <= 32
    assert spec["command"][1] == "benchmark/run.py"


def test_names_units_and_lines():
    spec = benchmark_spec()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[section]]
        assert len(set(names)) == len(names)
        for e in spec[section]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            assert all(_line(e[key]) for key in ("why", "layer") if key in e)
    assert all(_line(c["source"]) for c in spec["configs"])
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_cells_configs_and_files():
    spec = benchmark_spec()
    configs = {c["name"]: c for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = load_json("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"], w["why"])
        assert os.path.exists(os.path.join(HERE, "drivers", cell["driver"] + ".py"))
        load_json("traffic", w["traffic"])
        assert w["config"] in configs
        ends = [m["name"] for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in ends and len(ends) >= 2
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = load_json("configs", c["name"])
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
        assert all(k in data for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in spec["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in benchmark_spec()["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(load_module("metrics", metric).read)


def test_only_benchmark_files_under_paths():
    names = {n for n in os.listdir(HERE) if not n.startswith((".", "__pycache__"))}
    assert "BENCHMARK.json" not in names
    assert json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["paths"] == ["benchmark"]
