"""BENCHMARK.json against the contract's shape, and every cell resolving by
name to its files."""

import json
import os
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
DOC = spec.load_spec()
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(DOC["paths"]) <= 16 and all(PATH.match(p) for p in DOC["paths"])
    assert 1 <= len(DOC["command"]) <= 32
    for word in DOC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in DOC["paths"])
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_names_units_and_entry_keys():
    seen = set()
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    assert "setup_s" in seen


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(DOC, cell)
    assert os.path.isfile(c.config_path)
    assert os.path.isfile(spec.traffic_path(c.traffic_name))
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    for name in names:
        assert callable(spec.load_reader(name)), name
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    for key in ("width", "height", "spp", "depth", "warmup", "trace_seconds",
                "check_requests", "check_block", "limits"):
        assert key in c.traffic, key


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in DOC["workloads"]}
    assert used == {c["name"] for c in DOC["configs"]}
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert any(spec._reports(m, cell) for cell in CELLS), m["name"]


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.resolve(DOC, "no_such.cell")
