"""BENCHMARK.json keeps to its format: keys, names, units,
bounds, the files it names, and one chip a cell."""
import json
import re

import pytest

from portbench.harness import registry

SPEC = json.loads((registry.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def _names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            yield section, entry


@pytest.mark.parametrize("section,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else
                         x.get("name"))
def test_names_and_units(section, entry):
    assert NAME.match(entry["name"])
    if section == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in entry["reduced"])
        assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    elif section == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] == 1
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert LINE.match(entry["why"])
    else:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for cell in entry.get("workloads", ()):
            assert cell in [w["name"] for w in SPEC["workloads"]]
    if section == "end_to_end":
        assert set(entry) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
        assert 0.01 <= entry["bound"] <= 0.25
        assert entry["source"] in ("host_clock", "device_trace")
    if section == "per_layer":
        assert set(entry) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
        assert LINE.match(entry["layer"])
        assert entry["moves"] in [m["name"] for m in SPEC["end_to_end"]]


def test_unique_names():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = registry.Bench()
    for cell in b.cells():
        e2e = {m["name"] for m in b.metrics_for(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = b.metrics_for(cell, "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_every_config_is_used_and_layers_named_alike():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        cfg = json.loads((registry.CHECKOUT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        # a departure of the port's architecture is no cut of scale
        assert not set(c["reduced"]) & set(cfg.get("departures", {}))


def test_files_are_named_from_name_characters():
    for p in registry.ROOT.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(registry.CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
