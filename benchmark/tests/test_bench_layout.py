"""BENCHMARK.json, and the files it names, load by name and keep the contract's shape."""

from __future__ import annotations

import importlib.util
import json
import re

import pytest

from benchmark.cell import HERE, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_every_name_unit_and_line(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_loads_its_config_traffic_limits_and_readers(workload):
    spec = load_cell(workload)
    assert spec["cell"]["chips"] == 1
    assert spec["config"]["precision"] == "float32"
    for name in ("program", "reference", "checker"):
        assert callable(getattr(spec["entry"], name)), f"entries/{spec['traffic']['entry']}.py has {name}"
    assert spec["limits"], "every cell holds some numbers"
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert m["moves"] in names, f"{m['name']} moves a metric the cell reports"


@pytest.mark.parametrize("kind,entry", [("end_to_end", m) for m in BENCH["end_to_end"]]
                         + [("metrics", m) for m in BENCH["per_layer"]], ids=lambda e: getattr(e, "get", str)("name"))
def test_every_metric_has_a_reader_of_its_own(kind, entry):
    path = HERE / kind / f"{entry['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_a_config_file_states_what_it_reduced(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"]
    assert cfg["file"].startswith("benchmark/configs/")
    assert sum(c["file"] == cfg["file"] for c in BENCH["configs"]) == 1


def test_per_layer_metrics_of_one_layer_share_its_name():
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        suffix = m["name"].rsplit(".", 1)[-1]
        assert m["moves"].startswith(suffix), "a quantity split by the end-to-end metric it moves"
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in moves
