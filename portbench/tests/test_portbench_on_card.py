"""On the card (marked ``cuda``; they skip without one): a run of the
command prints the contract's last line, and the control fails the check at
the cell's own size, through the cell's own runner.  A cell that needs
more cards than the machine has is left to a machine that has them."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import bench, check
from portbench.tests.conftest import CELLS, ROOT

pytestmark = pytest.mark.cuda
SEED = 2**31 + 77


def test_a_run_prints_the_contract_line(cuda_device):
    """The last cell that fits the machine's cards."""
    cards = torch.cuda.device_count()
    name = [c for c in CELLS
            if bench.load_cell(c, ROOT).chips <= cards][-1]
    cell = bench.load_cell(name, ROOT)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name,
         "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["correct"] is True, rec["checks"]
    assert list(rec)[-1] == "checks"
    dev = rec["device"]
    assert dev["platform"] == "gpu" and dev["count"] == cell.chips
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert set(rec["metrics"]) == {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell, cuda_device):
    c = bench.load_cell(cell, ROOT)
    if c.chips > torch.cuda.device_count():
        pytest.skip(f"{cell} needs {c.chips} cards, the machine has "
                    f"{torch.cuda.device_count()}")
    run = bench.runner(c.traffic["runner"], ROOT)
    ref = run.reference_readings(c, SEED, cuda_device)
    control = run.reference_readings(c, SEED, cuda_device, precision="fp8")
    ok, checks = check.judge(check.gaps(control, ref), c.limits)
    assert ok is False, checks
