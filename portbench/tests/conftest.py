"""Shared helpers of the benchmark's tests: cells cut to the port's REDUCED
sizes, run on the CPU with one intra-op thread (the driver's test run puts
six workers on the machine's cores)."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import bench

ROOT = Path(__file__).resolve().parents[2]
WIDTHS = ("n_layers", "enc_layers", "d_model", "n_heads", "n_kv", "d_ff",
          "vocab", "n_frames", "q_chunk", "xent_chunk")
ARCH = {"whisper-tiny": "whisper-tiny",
        "starcoder2-7b-1layer": "starcoder2-7b"}
# rows, tokens, frames and workers of each traffic at the reduced size
TRAFFIC = {"artemis-w20-40x448": dict(rows=4, seq=16, frames=8, workers=2),
           "plain-40x448": dict(rows=4, seq=16, frames=8),
           "artemis-w1-4x4096": dict(rows=2, seq=32),
           "plain-4x4096": dict(rows=2, seq=32)}
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def reduced_cell(name: str) -> bench.Cell:
    """The cell ``name`` with its configuration cut to the port's REDUCED
    widths (remat as the cell runs it) and its traffic to a few short
    rows."""
    from repro_torch.configs import get_config
    cell = bench.load_cell(name, ROOT)
    small = dataclasses.asdict(get_config(ARCH[cell.config_name],
                                          reduced=True))
    cell.config.update({k: small[k] for k in WIDTHS if k in cell.config})
    cell.traffic.update(TRAFFIC[cell.traffic_name])
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
