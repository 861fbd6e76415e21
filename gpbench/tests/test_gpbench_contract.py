"""BENCHMARK.json against the form the benchmark keeps to: its keys, names
and units, and a file under gpbench/ for everything it names."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpbench"] and BENCH["command"][1] == "gpbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("gpbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("w", BENCH["workloads"], ids=[w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files_and_metrics(w):
    base = ROOT / "gpbench"
    assert (base / "traffic" / f"{w['traffic']}.json").is_file()
    assert (base / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or w["name"] in m["workloads"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (base / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"model", "host dispatch", "kernels", "device"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
