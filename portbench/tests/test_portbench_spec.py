"""Every file the harness finds by name loads, and ``BENCHMARK.json`` keeps
to the benchmark's contract (names, units, keys, bounds, cells).  Each
check takes the checkout's ``root``, so that a checkout with cells added
can be held to the same (``test_portbench_extend.py``)."""
import json
import re
from pathlib import Path

import pytest

from portbench import bench
from portbench.reference import for_config
from portbench.tests.conftest import CELLS, ROOT, missing_sizes

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def check_top_level(spec: dict) -> None:
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert spec["command"][1].startswith("portbench/")
    assert 1 <= spec["run_seconds"] <= 51


def check_cell(cell: str, root: Path) -> None:
    c = bench.load_cell(cell, root)
    run = bench.runner(c.traffic["runner"], root)
    assert c.chips in (1, 4) and c.chips in run.CHIPS, (c.chips, run.CHIPS)
    assert for_config(c.config, root).param_spec(c.config)
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


def check_sizes(cell: str, root: Path) -> None:
    missing = missing_sizes(cell, root)
    assert not missing, f"{cell} has no CPU size in {missing}"


def check_names(spec: dict, root: Path) -> None:
    cells = [w["name"] for w in spec["workloads"]]
    seen = set()
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert set(m["workloads"]) <= set(cells)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and len(w["why"]) <= 200
    for c in configs.values():
        assert (root / c["file"]).is_file()
        assert set(c["reduced"]) == set(json.loads(
            (root / c["file"]).read_text())["reduced"])
    assert {w["config"] for w in spec["workloads"]} == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    # a quarter of the cells, rounded down, may take four chips; one may
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_top_level_keys_and_command():
    check_top_level(BENCH)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    check_cell(cell, ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_its_cpu_sizes(cell):
    check_sizes(cell, ROOT)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(bench.metric_reader(metric, ROOT))


def test_names_units_and_keys():
    check_names(BENCH, ROOT)
