"""Every file the harness finds by name loads, and ``BENCHMARK.json`` keeps
to the benchmark's contract (names, units, keys, bounds, cells)."""
import json
import re

import pytest

from portbench import bench
from portbench.reference import model as RM
from portbench.tests.conftest import CELLS, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = bench.load_cell(cell, ROOT)
    assert c.chips == 1
    assert bench.runner(c.traffic["runner"]).run
    assert RM.param_spec(c.config)
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "peak_mem_gib"} <= names
    assert len(names & {"train_tok_per_s", "train_pos_per_s"}) == 1
    assert c.per_layer
    # each per-layer metric moves an end-to-end metric the cell reports
    assert {m["moves"] for m in c.per_layer} <= names
    # every number the check can give has a limit entry (null: not judged)
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(c.limits)
    if c.traffic["wire"]:
        assert {"h_gap", "hbar_gap"} <= set(c.limits)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(bench.metric_reader(metric))


def test_names_units_and_keys():
    seen = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and len(w["why"]) <= 200
    for c in configs.values():
        assert (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) == set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
