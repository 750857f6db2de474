"""BENCHMARK.json against the rules of its format: names, units and keys;
every file it names exists; every cell reports set-up, another end-to-end
metric and a per-layer one; every per-layer metric's cells report the
end-to-end metric it moves."""
import json
import re

import pytest

from portbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", *KEYS}
    assert MAN["command"] == ["python3", "portbench/run.py"] and MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_and_names(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_metric_sources_and_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MAN["end_to_end"])
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers <= {"service", "sample loop", "train step", "model step", "kernels", "device"}


def test_files_exist_for_every_name():
    for c in MAN["configs"]:
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert c["file"] == f"portbench/configs/{c['name']}.json" and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == [] and cfg["source"] == c["source"]
        assert all((harness.ROOT / y).is_file() for y in cfg["yaml"])
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        spec = harness.workload(w["name"])
        assert spec["config"] == w["config"] and spec.get("chips", 1) == w["chips"] == 1
        assert (harness.BENCH / "drivers" / f"{spec['driver']}.py").is_file()
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in MAN["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in harness.cell_metrics(MAN, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(MAN, cell, "per_layer")


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for m in MAN["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_limits_sit_in_each_cell_file():
    for cell in CELLS:
        limits = harness.workload(cell)["limits"]
        assert limits and all(v > 0 for v in limits.values()), cell
