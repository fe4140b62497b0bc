"""Shared helpers of the benchmark's tests: cells cut to a CPU size, run on
the CPU with one intra-op thread (the driver's test run puts six workers on
the machine's cores).

A cell's CPU size is two files found by name under ``tests/sizes/``:
``configs/<config>.json``, either ``{"reduced_from": <the port's config
name>}`` (the widths of the port's REDUCED config) or ``{"widths": {...}}``
(the widths themselves), and ``traffic/<traffic>.json``, the rows, tokens,
frames and workers of the traffic at that size.  Every helper takes the
checkout's ``root``."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import bench

ROOT = Path(__file__).resolve().parents[2]
SIZES = Path("portbench", "tests", "sizes")
WIDTHS = ("n_layers", "enc_layers", "d_model", "n_heads", "n_kv", "d_ff",
          "vocab", "n_frames", "q_chunk", "xent_chunk")


def cells(root: Path = ROOT) -> list:
    """The cells of the checkout's ``BENCHMARK.json``, in its order."""
    return [w["name"] for w in json.loads(
        (Path(root) / "BENCHMARK.json").read_text())["workloads"]]


def size_files(name: str, root: Path = ROOT) -> tuple:
    """The cell's two size files, relative to ``root``."""
    w = {w["name"]: w for w in json.loads(
        (Path(root) / "BENCHMARK.json").read_text())["workloads"]}[name]
    return (SIZES / "configs" / f"{w['config']}.json",
            SIZES / "traffic" / f"{w['traffic']}.json")


def missing_sizes(name: str, root: Path = ROOT) -> list:
    return [str(f) for f in size_files(name, root)
            if not (Path(root) / f).is_file()]


CELLS = cells()
# the cells the CPU tests run: those with both size files (all of them,
# unless one is missing, which the spec's test_cell_has_its_cpu_sizes
# names)
SIZED_CELLS = [c for c in CELLS if not missing_sizes(c)]


def reduced_cell(name: str, root: Path = ROOT) -> bench.Cell:
    """The cell ``name`` with its configuration cut to its CPU widths
    (remat as the cell runs it) and its traffic to a few short rows."""
    missing = missing_sizes(name, root)
    if missing:
        raise FileNotFoundError(f"no CPU size for {name}: {missing}")
    cell = bench.load_cell(name, root)
    cfg_size, tr_size = (json.loads((Path(root) / f).read_text())
                         for f in size_files(name, root))
    if "widths" in cfg_size:
        cell.config.update(cfg_size["widths"])
    else:
        from repro_torch.configs import get_config
        small = dataclasses.asdict(get_config(cfg_size["reduced_from"],
                                              reduced=True))
        cell.config.update({k: small[k] for k in WIDTHS
                            if k in cell.config})
    cell.traffic.update(tr_size)
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason: decided here, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
