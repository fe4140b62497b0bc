"""The port's analysis gate (``python -m repro_torch.analysis``) on the CPU:
each lint rule flags a constructed source and passes its clean twin, the
port's own tree is clean, the launch audit flags a per-cell loop and passes
the sweep, the wire checks pass every codec on both wires (and the
process-group ring) and flag a payload decompressed before the ring, the
in-place ring keeps its accumulator, and ``--ci --device cpu`` exits 0,
saying that ``host-sync`` (card only) was skipped.
"""
import json
import os
import subprocess

import pytest
import torch

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import astlint, findings, launch_audit
from repro_torch.analysis import wire_checks as wc
from repro_torch.core import codec as wire
from repro_torch.core import dist as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = "src/repro_torch/core/mod.py"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under the suite's worker processes torch's
    per-core pools spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (rule, path, source that breaks it, its clean twin)
RULE_CASES = [
    ("print-in-library", LIB, "def f():\n    print('x')\n",
     "def f():\n    return 'x'\n"),
    ("print-in-library", LIB,
     "def f():\n    print('x')\n",
     "def f():\n    print('x')  # repro-lint: allow=print-in-library\n"),
    ("port-imports-reference", LIB, "import jax.numpy as jnp\n",
     "import torch\n"),
    ("port-imports-reference", "chip_smoke.py",
     "from repro.core import sweep\n",
     "from repro_torch.core import sweep\n"),
    ("hardcoded-device", LIB, "def run(x, device='cpu'):\n    return x\n",
     "def run(x, device=None):\n    return x\n"),
    ("hardcoded-device", LIB,
     "import torch\ndef run(x, *, device=torch.device('cuda')):\n"
     "    return x\n",
     "def _helper(x, device='cpu'):\n    return x\n"),
    ("mutable-default", LIB, "def f(x=[]):\n    return x\n",
     "def f(x=()):\n    return x\n"),
    ("mutable-default", "tests/test_torch_x.py",
     "def f(*, opts=dict()):\n    return opts\n",
     "def f(*, opts=None):\n    return opts or {}\n"),
]


@pytest.mark.parametrize("rule,path,bad,clean", RULE_CASES)
def test_lint_rule_flags_bad_and_passes_clean(rule, path, bad, clean):
    got = [f for f in astlint.lint_source(path, bad) if f.rule == rule]
    assert got and all(not f.suppressed for f in got)
    assert got[0].severity == astlint.RULES[rule]
    assert not findings.active(
        [f for f in astlint.lint_source(path, clean) if f.rule == rule])


def test_prints_are_allowed_in_clis_and_outside_the_library():
    src = "print('x')\n"
    for path in ("src/repro_torch/bench/__main__.py",
                 "src/repro_torch/launch/report.py", "chip_smoke.py",
                 "tests/test_torch_x.py"):
        assert not astlint.lint_source(path, src)
    # the reference's tests may import both packages
    assert not astlint.lint_source("tests/test_torch_x.py", "import jax\n")


def test_tracked_bytecode(tmp_path):
    subprocess.run(["git", "init", "-q"], cwd=tmp_path, check=True)
    (tmp_path / "m.pyc").write_bytes(b"\0")
    assert not astlint.hygiene_findings(str(tmp_path))
    subprocess.run(["git", "add", "-f", "m.pyc"], cwd=tmp_path, check=True)
    got = astlint.hygiene_findings(str(tmp_path))
    assert [(f.rule, f.path) for f in got] == [("tracked-bytecode",
                                                "m.pyc")]


def test_port_tree_is_clean():
    fs = astlint.lint_paths(root=ROOT) + astlint.hygiene_findings(ROOT)
    assert not findings.active(fs), [f.format() for f in fs]
    paths = {f.replace(os.sep, "/") for f in astlint.expand(
        astlint.DEFAULT_PATHS, ROOT)}
    assert any(p.endswith("chip_smoke.py") for p in paths)
    assert any(p.endswith("tests/test_torch_analysis.py") for p in paths)
    assert not any("/repro/" in p for p in paths)


def test_baseline_is_well_formed():
    entries = findings.load_baseline(cli.BASELINE)
    assert all(e.get("reason") for e in entries)


def test_launch_audit_flags_a_per_cell_loop():
    def per_cell(cells):
        def run(rounds):
            x = torch.zeros(cells, 8)
            for _ in range(rounds):
                for c in range(cells):          # one op a cell: the bug
                    x[c] = x[c] + 1.0
        return launch_audit.per_round(run, 2)

    def batched(cells):
        def run(rounds):
            x = torch.zeros(cells, 8)
            for _ in range(rounds):
                x = x + 1.0
        return launch_audit.per_round(run, 2)

    got = launch_audit.audit_no_growth(per_cell, (8, 16), "loop")
    assert [f.rule for f in got] == ["launch-growth"]
    assert not launch_audit.audit_no_growth(batched, (8, 16), "batched")


def test_launch_audit_passes_the_port():
    assert launch_audit.audit_entry_points("cpu") == []


def test_wire_checks_pass_every_codec_and_wire():
    assert wc.audit_codec_wires("cpu") == []
    assert "tile_squant" in wire.available() and len(D.WIRES) == 2


def test_wire_check_flags_a_payload_decompressed_before_the_ring(
        monkeypatch):
    class Decompressing(wc.CountingAxis):
        """A ring that decodes each payload and sends the f32 values."""

        def ring(self, codec, payload):
            dec = codec.decode(payload)
            sent = wire.make_codec("identity", dec.shape[-1]).encode(dec)
            self._payload(sent, False)
            return dec.sum(0)

    params = wc._toy_params()
    dcfg = D.DistConfig(variant="artemis", s=3)
    monkeypatch.setattr(wc, "CountingAxis", Decompressing)
    measured = wc.measure_wire(dcfg, params, wc.TOY_W, "cpu")
    got = wc.wire_findings(measured, wc.model_bytes(dcfg, params, wc.TOY_W),
                           "bad", payload_f32_bytes=1e9)
    assert [f.rule for f in got] == ["uncompressed-wire"]
    assert ("ring", "f32") in measured and ("ring", "s8") not in measured


def test_wire_check_flags_a_dense_all_reduce():
    declared = {("ring", "s8"): 100.0, ("ring", "f32"): 8.0}
    measured = dict(declared)
    measured[("all-reduce", "f32")] = 400.0
    got = wc.wire_findings(measured, declared, "psum",
                           payload_f32_bytes=400.0)
    assert [f.rule for f in got] == ["f32-allreduce-payload"]
    measured[("all-reduce", "f32")] = 12.0           # a few metric scalars
    assert not wc.wire_findings(measured, declared, "ok",
                                payload_f32_bytes=400.0)


def test_process_group_ring_matches_the_wire_model():
    assert wc.audit_pg_ring("cpu") == []


def test_ring_keeps_its_accumulator(monkeypatch):
    assert wc.audit_donation("cpu") == []

    def out_of_place(acc, q, scales, hop):
        return acc.clone().add_(q.to(acc.dtype) * scales)

    monkeypatch.setattr(D, "bucket_acc_hop_", out_of_place)
    assert [f.rule for f in wc.audit_donation("cpu")] == [
        "missing-donation"]


def test_host_sync_needs_the_card():
    with pytest.raises(ValueError, match="card"):
        wc.audit_host_sync("cpu")


def test_cli_ci_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "f.json"
    sarif = tmp_path / "f.sarif"
    assert cli.main(["--ci", "--device", "cpu", "--json", str(out),
                     "--sarif", str(sarif), "-q"]) == 0
    assert "host-sync skipped" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert rep["counts"]["active"] == 0
    assert json.loads(sarif.read_text())["version"] == "2.1.0"


def test_cli_fails_on_an_active_finding(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import jax\n")
    rc = cli.main(["--paths", str(bad)])
    assert rc == 1
    assert "port-imports-reference" in capsys.readouterr().out
