"""What a run reads, found by name: ``BENCHMARK.json`` at the checkout's
root, a configuration's file (its ``file`` there), a traffic mix
(``portbench/traffic/<traffic>.json``), a cell's limits
(``portbench/limits/<cell>.json``), a per-layer metric's reader
(``portbench/metrics/<metric>.py``, or its stem's), a runner
(``portbench/runners/<runner>.py``, named by the traffic's ``runner``)
and a configuration's plain reference (``portbench/reference/<module>.py``,
named by the configuration's ``reference``; see
``portbench.reference.for_config``).  A later configuration, cell, metric
or runner is new files and entries: nothing here changes.

Every lookup takes the checkout's ``root``; under another root than this
package's own, a module is loaded from that root's file.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what a runner provides besides ``CHIPS``, the tuple of the chip counts
# it runs on: ``run(Run) -> result``, and the two sides of the check's
# readings, ``program_readings(cell, seed, device)`` and
# ``reference_readings(cell, seed, device, precision="f32", fault=None)``
RUNNER_FUNCTIONS = ("run", "program_readings", "reference_readings")


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
    root: Path = ROOT         # the checkout it was found in


@dataclasses.dataclass
class Run:
    """One run of a cell, as ``run.py`` hands it to the cell's runner."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object            # the run's first device, a torch.device
    t0: float                 # the process's start, host clock


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
    here = Path(root) / "portbench"
    return Cell(
        name=name, chips=w["chips"], config_name=w["config"],
        config=_json(Path(root) / cfg["file"]), traffic_name=w["traffic"],
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=Path(root))


def _load(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod       # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def module(folder: str, name: str, root: Path = ROOT):
    """``portbench/<folder>/<name>.py`` of the checkout at ``root``: this
    package's own module where ``root`` is its checkout, else the file
    under ``root``, loaded under a name of that root's own."""
    if Path(root).resolve() == ROOT:
        return importlib.import_module(f"portbench.{folder}.{name}")
    tag = abs(hash(str(Path(root).resolve())))
    key = f"portbench_{tag}_{folder}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    return _load(Path(root) / "portbench" / folder / f"{name}.py", key)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(trace)`` of ``portbench/metrics/<name>.py``; a quantity split
    by the end-to-end metric it moves (``grads.device_ms.lm``,
    ``grads.device_ms.speech``) without a file of its own is read by its
    stem's (``grads.device_ms``)."""
    here = Path(root) / "portbench" / "metrics"
    path = here / f"{name}.py"
    if not path.is_file() and "." in name:
        path = here / f"{name.rsplit('.', 1)[0]}.py"
    return _load(path, f"portbench.metrics.{name.replace('.', '_')}").read


def runner(name: str, root: Path = ROOT):
    """The runner ``portbench/runners/<name>.py``, checked to provide
    ``CHIPS`` and ``RUNNER_FUNCTIONS``."""
    mod = module("runners", name, root)
    missing = [f for f in ("CHIPS",) + RUNNER_FUNCTIONS
               if not hasattr(mod, f)]
    if missing:
        raise AttributeError(f"runner {name!r} lacks {missing}")
    return mod
