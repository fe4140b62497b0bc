"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

Tolerances: the catalogue, the histogram's buckets, every counter and the
bit gauges exactly; the compression-error gauges, the aggregate's norm and
the memory drift to rtol 1e-4 (the sweeps' own bar: the port's gradients
and norms differ from the reference's in the last bits); telemetry on and
off bit for bit on the port.  The events and the CLI are held to the
reference's schema checker, ``repro.obs.events.validate_events``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artemis as jart
from repro.core import sweep as jsw
from repro.obs import events as jev
from repro.obs import telemetry as jtel
from repro.optim import optimizers as jopt
from repro_torch.core import artemis as tart
from repro_torch.core import sweep as tsw
from repro_torch.obs import __main__ as tcli
from repro_torch.obs import bench as tbench
from repro_torch.obs import events as tev
from repro_torch.obs import spans as tspans
from repro_torch.obs import telemetry as ttel
from repro_torch.optim import optimizers as topt
from test_torch_faults import (FaultReplayNoise, MATRIX, N, D, _both,
                               jprob, tprob)  # noqa: F401 (fixtures)

GAUGES_RTOL = ("err_up", "err_dwn", "ghat_norm", "mem_drift", "e_norm")


def test_catalogue_is_the_references():
    port = [(m.name, m.kind, m.unit, m.doc, m.edges)
            for m in ttel.catalogue()]
    ref = [(m.name, m.kind, m.unit, m.doc, m.edges)
           for m in jtel.catalogue()]
    assert port == ref
    for name in ("SWEEP_COUNTERS", "SWEEP_GAUGES", "SWEEP_EVAL_GAUGES",
                 "SWEEP_METRICS", "MESH_METRICS", "ERR_EDGES", "_PACK"):
        assert getattr(ttel, name) == getattr(jtel, name), name
    assert tev.SCHEMA == jev.SCHEMA
    assert tev.SCHEMA_VERSION == jev.SCHEMA_VERSION
    assert set(ttel.mesh_zeros("cpu")) == set(jtel.mesh_zeros())


def test_hist_buckets_match_reference():
    vals = np.array([0.0, 1e-13, 1e-12, 1.5e-12, 1e-2, 0.5, 1e6, 2e6,
                     np.inf, -np.inf, np.nan, -1.0], np.float32)
    ref = jtel.hist_zeros(jtel.ERR_UP_HIST)
    for v in vals:
        ref = jtel.hist_add(ref, jtel.ERR_UP_HIST, v)
    one = ttel.hist_zeros(ttel.ERR_UP_HIST)
    for v in vals:
        one = ttel.hist_add(one, ttel.ERR_UP_HIST, torch.tensor(v))
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref))
    # a batch of cells at once: one row per value
    many = ttel.hist_add(ttel.hist_zeros(ttel.ERR_UP_HIST, (len(vals),)),
                         ttel.ERR_UP_HIST, torch.from_numpy(vals))
    np.testing.assert_array_equal(many.sum(0).numpy(), np.asarray(ref))
    assert (many.sum(-1) == 1).all()


def test_pack_round_emit_reset_match_reference():
    rng = np.random.default_rng(0)
    rounds = [dict(avail=float(rng.integers(0, 8)),
                   uplink_bits=float(rng.random() * 1e4),
                   err_up=float(rng.random()), ghat_norm=float(rng.random()))
              for _ in range(5)]
    ref = jtel.sweep_zeros()
    port = ttel.sweep_zeros((1,))
    for r in rounds:
        ref = jtel.sweep_accumulate(ref, jtel.sweep_round(**r))
        port = ttel.sweep_accumulate(port, ttel.sweep_round(
            **{k: torch.tensor([v], dtype=torch.float32)
               for k, v in r.items()}))
    jr = jtel.sweep_emit(ref, 5, rollbacks=jnp.float32(2.0))
    tr = ttel.sweep_emit(port, 5, rollbacks=torch.tensor([2.0]))
    assert list(tr) == list(jr)
    for k in jr:
        np.testing.assert_array_equal(tr[k][0].numpy(), np.asarray(jr[k]),
                                      err_msg=k)
    jz, tz = jtel.sweep_reset_stride(ref), ttel.sweep_reset_stride(port)
    np.testing.assert_array_equal(tz["pack"][0].numpy(),
                                  np.asarray(jz["pack"]))


def _telemetry_sweeps(jprob, tprob, cfg_kw, p, iters, gammas, seeds, batch,
                      every):
    ref = jsw.run_sweep(jprob, _both(jart, cfg_kw, p), gammas, seeds, iters,
                        batch=batch, eval_every=every, telemetry=True)
    noise = FaultReplayNoise(seeds, iters, N, D, batch, tprob.X.shape[1])
    out = tsw.run_sweep(tprob, _both(tart, cfg_kw, p), gammas, seeds, iters,
                        batch=batch, eval_every=every, device="cpu",
                        noise=noise, telemetry=True)
    off = tsw.run_sweep(tprob, _both(tart, cfg_kw, p), gammas, seeds, iters,
                        batch=batch, eval_every=every, device="cpu",
                        noise=noise)
    return ref, out, off


def test_faulted_sweep_telemetry_matches_reference(jprob, tprob):
    """A faulted grid with sentinel rollbacks: a blowup cell (entry scrub)
    and a blowup-to-1e15 cell that rolls back, plus stragglers over a
    Markov chain."""
    cfg_kw = MATRIX[:2] + [dict(straggler_rate=0.3, p_stay=0.8, scrub=True)]
    ref, out, off = _telemetry_sweeps(jprob, tprob, cfg_kw, 0.7, 40, [0.02],
                                      [0, 3], 4, 5)
    assert out.rollbacks.sum() >= 1
    assert set(out.telemetry) == set(ref.telemetry)
    for k, r in ref.telemetry.items():
        r, o = np.asarray(r), out.telemetry[k]
        assert o.shape == r.shape, k
        if k in GAUGES_RTOL:
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(o, r, err_msg=k)
    t = out.telemetry
    assert t["blowup_hits"][0].max() > 0 and t["straggler_drops"][2].max() > 0
    assert t["rollbacks"][1, ..., -1].min() >= 1
    assert t["err_up_hist"].shape[-1] == len(ttel.ERR_EDGES) + 1
    # telemetry moves no number of the run
    assert off.telemetry is None
    for f in ("losses", "bits", "dists", "w_final", "w_avg", "w_tail_avg",
              "rollbacks", "gamma_scale"):
        assert np.array_equal(getattr(out, f), getattr(off, f),
                              equal_nan=True), f


def test_clean_sweep_telemetry_matches_reference(jprob, tprob):
    ref, out, _ = _telemetry_sweeps(jprob, tprob, [None], 0.5, 20,
                                    [0.01, 0.02], [1], 2, 10)
    for k, r in ref.telemetry.items():
        fn = (np.testing.assert_array_equal if k not in GAUGES_RTOL else
              lambda a, b, err_msg: np.testing.assert_allclose(
                  a, b, rtol=1e-4, atol=1e-6, err_msg=err_msg))
        fn(out.telemetry[k], np.asarray(r), err_msg=k)


def test_telemetry_with_checkpoint_dir_raises(tprob, tmp_path):
    cfg = tart.variant_config("artemis", D, N)
    with pytest.raises(ValueError, match="telemetry"):
        tsw.run_sweep(tprob, [cfg], [0.01], [0], 10, device="cpu",
                      telemetry=True, checkpoint_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# events, spans, the bench ledger
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_events(tprob, tmp_path_factory):
    cfgs = _both(tart, [None, dict(blowup_rate=0.2, scrub=True)], 0.7)
    res = tsw.run_sweep(tprob, cfgs, [0.02], [0, 1], 20, batch=2,
                        eval_every=5, device="cpu", telemetry=True)
    path = str(tmp_path_factory.mktemp("events") / "events.jsonl")
    with tev.EventLog(path) as log:
        log.start(config={"iters": 20}, fingerprint="test")
        n = tev.record_sweep(log, res, cfgs=cfgs)
        log.emit("wire", wire="leaf", reduce_impl="pipelined",
                 measured_bytes=10.0, model_bytes=10.0)
        log.end(status="ok", wall_s=1.0)
    return path, res, n


def test_port_events_pass_the_reference_schema(sweep_events):
    path, res, n = sweep_events
    evs = jev.read_events(path)
    assert n == 2 * 2 * res.losses.shape[-1]
    assert jev.validate_events(evs) == []
    assert tev.validate_events(tev.read_events(path)) == []
    evals = [e for e in evs if e["ev"] == "eval"]
    assert set(evals[0]["metrics"]) == set(jtel.SWEEP_METRICS)
    s = tev.summarize(evs)
    assert s["schema_errors"] == [] and s["status"] == "ok"
    assert s == jev.summarize(evs)


def test_events_reject_what_the_reference_rejects():
    bad = [{"ev": "eval", "t": 0, "run_id": "x", "cell": {}, "iter": 0,
            "loss": 0, "bits": 0, "dist": 0, "metrics": {"nope": 1.0}},
           {"ev": "nope"},
           {"ev": "eval", "t": 0, "run_id": "x", "cell": {}, "iter": 0,
            "loss": 0, "bits": 0, "dist": 0,
            "metrics": {"err_up_hist": 1.0, "active": [1.0]}},
           {"ev": "span", "name": "a"}]
    for rec in bad:
        assert tev.validate_event(rec) == jev.validate_event(rec) != []
    with pytest.raises(ValueError, match="invalid"):
        tev.EventLog(None).emit("span", name="a")


def test_spans_record_sink_and_split(tmp_path):
    tspans.reset()
    path = str(tmp_path / "spans.jsonl")
    with tev.EventLog(path) as log:
        tspans.install_sink(log)
        try:
            with tspans.span("outer", k=1):
                with tspans.span("inner"):
                    torch.ones(3).sum()
            split = tspans.compile_execute_split(lambda x: x * 2,
                                                 torch.ones(4))
        finally:
            tspans.uninstall_sink()
    names = [r.name for r in tspans.records()]
    assert names == ["inner", "outer", "obs/compile", "obs/execute"]
    assert tspans.records()[0].depth == 1 and tspans.total("outer") > 0
    assert split["first_call_s"] >= 0 and split["execute_s"] >= 0
    assert split["compile_s"] == split["first_call_s"] - split["execute_s"]
    evs = jev.read_events(path)
    assert [e["name"] for e in evs] == names and jev.validate_events(evs) == []
    agg = tspans.summarize_spans()
    assert {a["name"] for a in agg} == set(names)


def test_profile_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with tspans.profile(d):
        with tspans.span("obs/traced"):
            torch.randn(16, 16) @ torch.randn(16, 16)
    arts = tspans.perfetto_artifacts(d)
    assert len(arts) == 1
    with open(arts[0]) as f:
        trace = json.load(f)
    assert any(e.get("name") == "obs/traced"
               for e in trace["traceEvents"])
    assert tspans.perfetto_artifacts(str(tmp_path / "missing")) == []


def test_a_phase_without_a_profiler_records_and_launches_nothing(
        monkeypatch):
    from repro_torch.kernels import _build
    launched = []
    monkeypatch.setattr(tspans, "_mark", lambda: launched.append(1))
    tspans.reset()
    x = torch.ones(3, requires_grad=True)
    with tspans.phase("step", step=0, wire_bytes=1.0) as ph:
        y = x * 2.0
        ph.backward(x, y)
    y.sum().backward()
    assert tspans.phases() == [] and launched == []
    assert not x._backward_hooks and not y._backward_hooks
    assert "phase_mark" not in _build._LOADED
    # under a profiler: a record and a marker at each end, the block's
    # backward among them
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tspans.phase("step", step=3, wire_bytes=1.0):
            with tspans.phase("inner") as ph:
                y = x * 2.0
                ph.backward(x, y)
            y.sum().backward()
    outer, inner, bwd = tspans.phases()
    assert len(launched) == 6
    assert (outer.step, outer.counts, inner.step, inner.parent) == (
        3, {"wire_bytes": 1.0}, 3, "step")
    assert outer.seq < inner.seq < inner.end_seq < bwd.seq < bwd.end_seq \
        < outer.end_seq
    assert outer.pass_ == inner.end_pass == "forward"
    assert (bwd.name, bwd.pass_, bwd.parent) == ("inner", "backward", "step")


def test_no_phases_keeps_a_capture_free_of_phases(monkeypatch):
    launched = []
    monkeypatch.setattr(tspans, "_mark", lambda: launched.append(1))
    tspans.reset()
    x = torch.ones(3, requires_grad=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tspans.no_phases():
            with tspans.phase("step", step=0) as ph:
                y = x * 2.0
                ph.backward(x, y)
            y.sum().backward()
        assert tspans._QUIET == [0]
        with tspans.phase("step", step=1):
            pass
    assert [r.step for r in tspans.phases()] == [1] and len(launched) == 2
    assert not y._backward_hooks


@pytest.mark.parametrize("reduce_impl", ["pipelined", "psum"])
def test_the_rings_wire_bytes_are_telemetrys(reduce_impl):
    from repro_torch.core import dist
    from repro_torch.models.toy import ToyMLP
    model = ToyMLP(4, 64)
    params = model.init(torch.Generator().manual_seed(0))
    batch = model.batch(torch.Generator().manual_seed(1), 32)
    dcfg = dist.DistConfig(seed=3, bucket_bytes=4096, max_buckets=8,
                           bucket_row=64, reduce_impl=reduce_impl,
                           telemetry=True)
    init, step = dist.make_train_step(model, topt.adam(1e-3), dcfg, 4,
                                      torch.device("cpu"))
    tspans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, (_, metrics) = step(init(params), batch)
    ring = [r for r in tspans.phases() if r.name == "wire/ring"]
    assert len(ring) == 1
    assert ring[0].counts["wire_bytes"] == metrics["obs"]["wire_bytes"] > 0


@pytest.mark.parametrize("direction,values,verdict", [
    ("lower", [10.0, 11.0, 13.0], "regression"),
    ("lower", [10.0, 11.0, 12.0], "ok"),
    ("higher", [10.0, 8.0], "ok"), ("higher", [10.0, 7.0], "regression"),
    ("lower", [5.0], "baseline")])
def test_bench_gate_matches_reference(tmp_path, direction, values, verdict):
    from repro.obs import bench as jbench
    paths = []
    for mod, name in ((tbench, "port"), (jbench, "ref")):
        path = str(tmp_path / f"{name}.jsonl")
        for v in values:
            mod.append(path, "m", v, "s", direction=direction, tol=0.2)
        paths.append(path)
    (tv,), (jv,) = tbench.check(paths[0]), jbench.check(paths[1])
    assert (tv.status, tv.latest, tv.best) == (jv.status, jv.latest,
                                               jv.best) and tv.status == \
        verdict
    assert tv.describe() == jv.describe()
    assert [e["value"] for e in tbench.load(paths[1])] == values


# ---------------------------------------------------------------------------
# the CLI, on the CPU
# ---------------------------------------------------------------------------

def test_cli_subcommands(sweep_events, tmp_path, capsys):
    path, _, _ = sweep_events
    assert tcli.main(["validate", path]) == 0
    assert "0 schema errors" in capsys.readouterr().out
    assert tcli.main(["summary", path]) == 0
    assert "cell 0/0/0" in capsys.readouterr().out
    assert tcli.main(["summary", path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["schema_errors"] == []
    assert tcli.main(["diff", path, path]) == 0
    dash = str(tmp_path / "dash.md")
    assert tcli.main(["dashboard", path, "-o", dash]) == 0
    md = open(dash).read()
    assert "## Telemetry (final eval point)" in md and "## Wire bytes" in md
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps({"ev": "nope"}) + "\n")
    assert tcli.main(["validate", bad]) == 1
    ledger = str(tmp_path / "ledger.jsonl")
    for v in ("1.0", "1.1"):
        assert tcli.main(["bench-append", ledger, "x", v, "s",
                          "--tol", "0.5"]) == 0
    assert tcli.main(["bench-check", ledger]) == 0
    assert tcli.main(["bench-append", ledger, "x", "9.0", "s"]) == 0
    assert tcli.main(["bench-check", ledger]) == 1


def test_cli_smoke_on_the_cpu(tmp_path, capsys):
    out, ledger = tmp_path / "obs", tmp_path / "ledger.jsonl"
    rc = tcli.main(["smoke", "-o", str(out), "--iters", "20", "--every",
                    "5", "--device", "cpu", "--ledger", str(ledger)])
    text = capsys.readouterr().out
    assert rc == 0, text
    evs = jev.read_events(str(out / "events.jsonl"))
    assert jev.validate_events(evs) == []
    assert evs[0]["ev"] == "run_start" and evs[-1]["ev"] == "run_end"
    assert (out / "dashboard.md").exists()
    assert tspans.perfetto_artifacts(str(out / "trace"))
    names = [e["name"] for e in tbench.load(str(ledger))]
    assert "obs_smoke.blowup_hits" in names and len(names) == 6
    # nothing is written outside -o and the ledger
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ledger.jsonl",
                                                          "obs"]
    assert tcli.main(["validate", str(out / "events.jsonl")]) == 0


def test_cli_smoke_without_a_ledger_writes_none(tmp_path, capsys):
    out = tmp_path / "obs"
    assert tcli.main(["smoke", "-o", str(out), "--iters", "10", "--every",
                      "5", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["obs"]


# ---------------------------------------------------------------------------
# cosine_lr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,warmup,total,floor", [
    (0.1, 10, 100, 0.1), (1.0, 0, 50, 0.0), (3e-4, 5, 5, 0.2)])
def test_cosine_lr_matches_reference(base, warmup, total, floor):
    j, t = jopt.cosine_lr(base, warmup, total, floor), topt.cosine_lr(
        base, warmup, total, floor)
    steps = np.arange(0, total + 20, dtype=np.int32)
    ref = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
    out = t(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-9)
    assert float(t(3)) == pytest.approx(float(j(jnp.int32(3))), rel=1e-6)
