"""The port's benchmark CLI (``python -m repro_torch.bench``) on the CPU at
its smoke size: every suite yields well-formed ``(name, us_per_call,
derived)`` rows, the kernel rows say that only the plain versions ran, the
reports land under the output directory, the CLI mirrors its rows into the
event log and exits 1 when a suite raises.  Times on the CPU are no
device's and nothing here reads them.
"""
import csv
import io
import json
import math

import pytest
import torch

from repro_torch.bench import Context
from repro_torch.bench import __main__ as cli
from repro_torch.bench import fault_bench, hillclimb
from repro_torch.obs import events as obs_events

SUITE_NAMES = [name for name, _ in cli.SUITES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under the suite's worker processes torch's
    per-core pools spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_reference_suite_has_a_port():
    assert SUITE_NAMES == [
        "fig3a", "fig3b", "fig4_bits", "fig56", "table3", "thm3", "kernel",
        "kernel/b1_probe", "sweep_engine", "bucketed_ring", "dist_step",
        "fault_overhead"]


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_suite_rows_are_well_formed(name, tmp_path):
    ctx = Context(fast=True, device=torch.device("cpu"),
                  out_dir=str(tmp_path))
    rows = dict(cli.SUITES)[name](ctx)
    assert rows
    for row, us, derived in rows:
        assert isinstance(row, str) and "," not in row and "/" in row
        assert isinstance(us, float) and (math.isfinite(us) or
                                          math.isnan(us))
        assert isinstance(derived, str) and derived
        if row.startswith("kernel/") and row != "kernel/wire_ratio":
            # no kernel runs on the CPU, and no row claims one did
            assert "device=cpu" in derived and "device_us" not in derived
    if name == "sweep_engine":
        rep = json.loads((tmp_path / "bench_sweep.json").read_text())
        assert rep["grid"]["cells"] == 1 and rep["device"] == "cpu"
        assert rep["ops_per_round"]["sweep"] > 0
    if name == "bucketed_ring":
        rep = json.loads((tmp_path / "bench_dist.json").read_text())
        for w in ("leaf", "bucketed"):
            assert rep["wires"][w]["wire_guard"]["ok"], rep["wires"][w]


def test_cli_prints_csv_and_mirrors_events(tmp_path, capsys):
    ev = tmp_path / "events.jsonl"
    rc = cli.main(["table3", "--fast", "--device", "cpu", "--out-dir",
                   str(tmp_path), "--events", str(ev)])
    assert rc == 0
    out = capsys.readouterr().out
    rows = list(csv.reader(io.StringIO(out)))
    assert rows[0] == ["name", "us_per_call", "derived"]
    assert [r[0] for r in rows[1:]] == ["table3/sgd"]
    events = obs_events.read_events(str(ev))
    assert not obs_events.validate_events(events)
    bench = [e for e in events if e["ev"] == "bench"]
    assert [e["name"] for e in bench] == ["table3/sgd"]


def test_cli_reports_a_failing_suite(tmp_path, capsys, monkeypatch):
    def broken(ctx):
        raise RuntimeError("a suite failed")

    monkeypatch.setattr(cli, "SUITES", cli.SUITES + [("broken", broken)])
    rc = cli.main(["broken", "--fast", "--device", "cpu", "--out-dir",
                   str(tmp_path)])
    captured = capsys.readouterr()
    assert rc == 1
    assert "broken,NaN,ERROR" in captured.out
    assert "a suite failed" in captured.err


def test_cli_runs_on_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["table3", "--fast", "--out-dir", str(tmp_path)])


def test_fault_matrix_cli(capsys):
    assert fault_bench.main(["--matrix", "--device", "cpu"]) == 0
    assert "fault matrix: OK" in capsys.readouterr().out


def test_hillclimb_runs_one_combo_in_a_subprocess():
    rec = hillclimb.run("whisper-tiny", "long_500k", "none")
    assert rec["status"] == "skip" and "encoder-decoder" in rec["reason"]
    line = hillclimb.show("x", {"status": "ok", "compute_s": 1.0,
                                "memory_s": 2.0, "wire_s": 0.5,
                                "dominant": "memory", "peak_bytes": 3e9,
                                "useful_ratio": 0.5})
    assert "C=1.000s M=2.000s X=0.500s dom=memory" in line
