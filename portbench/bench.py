"""What a run reads, found by name: ``BENCHMARK.json`` at the checkout's
root, a configuration's file (its ``file`` there), a traffic mix
(``portbench/traffic/<traffic>.json``), a cell's limits
(``portbench/limits/<cell>.json``), a per-layer metric's reader
(``portbench/metrics/<metric>.py``, or its stem's) and a runner
(``portbench/runners/<runner>.py``, named by the traffic's ``runner``).
A later cell, metric or runner is new files and entries: nothing here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict              # the configuration as run
    traffic_name: str
    traffic: dict
    limits: Dict[str, Optional[float]]
    end_to_end: List[dict]    # the metrics this cell reports, trace 0
    per_layer: List[dict]     # and trace 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"], config_name=w["config"],
        config=_json(root / cfg["file"]), traffic_name=w["traffic"],
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str) -> Callable:
    """``read(trace)`` of ``portbench/metrics/<name>.py``; a quantity split
    by the end-to-end metric it moves (``grads.device_ms.lm``,
    ``grads.device_ms.speech``) without a file of its own is read by its
    stem's (``grads.device_ms``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(name: str):
    return importlib.import_module(f"portbench.runners.{name}")
