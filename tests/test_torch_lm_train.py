"""The port's LM training and serving path against the JAX package's, on the
CPU: the synthetic corpus, one whole Artemis step of a language model on
the bucketed wire, the plain data-parallel step, and the train and serve
CLIs (checkpoint and resume, the sentinel, the event log).

Tolerances:
  * the corpus: bit for bit;
  * the whole Artemis steps of reduced starcoder2 (f32 compute, W = 4,
    sgd(0.05), 3 steps) against the reference's ``make_train_step`` on 4
    fake CPU devices, with the reference's draws replayed
    (``test_torch_dist.JaxMeshReplay``): ``test_torch_dist.py``'s
    whole-step bars (losses to rtol 1e-4; parameters, h and hbar to rtol
    1e-4, atol 1e-6 on all but 1e-3 of the parameters, 1e-4 of the h
    entries and W * 1e-4 of the hbar entries; every parameter to atol
    1e-4), for the reasons stated there;
  * the plain data-parallel step (``dcfg=None``, f32 compute, sgd(0.1), 3
    steps) against the reference's on one device: losses to rtol 1e-5,
    parameters to atol 1e-6;
  * resuming from a checkpoint: bit for bit with the run that did not
    stop, over ranks too;
  * the CLI over 2 gloo ranks (``--ranks 2``) against the simulated W = 2
    run: the logged losses to 2e-4 (they are rounded to 4 decimals), rank
    0's parameters, adam moments and hbar, and each rank's h against the
    simulated worker's, to rtol 1e-4, atol 1e-6 (a rank's matmul may
    round otherwise than the vmapped one; measured: bit for bit).

The whole-step reference needs 4 CPU devices, fixed when JAX starts, so it
runs once per module in a subprocess: this file re-invokes itself with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and reads the
``.npz`` it writes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dist as jdist
from repro.data import synthetic as jsyn
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import build_model as jbuild
from repro.optim import sgd as jsgd
from repro_torch import configs as tconfigs
from repro_torch import convert, experiments
from repro_torch.checkpoint import checkpointer
from repro_torch.core import dist as tdist
from repro_torch.data import synthetic as tsyn
from repro_torch.data.pipeline import Batches, ShardedBatches
from repro_torch.kernels import KERNELS
from repro_torch.launch import serve, train
from repro_torch.models.model import build_model, flatten_params
from repro_torch.obs import events as tevents
from repro_torch.optim import sgd
from test_torch_dist import JaxMeshReplay, assert_mostly_close

W = 4
ARCH = "starcoder2-7b"
STEP_BATCH, STEP_SEQ, STEPS = 8, 64, 3
WIRE = dict(variant="artemis", s=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and each of torch's default pool (one thread a
    core) spins against the others' (this module took 20x its serial time
    that way).  The previous count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(module):
    return dataclasses.replace(module.get_config(ARCH, reduced=True),
                               compute_dtype="float32")


def _stream_cfg(module, vocab):
    return module.TokenStreamConfig(vocab=vocab, seq_len=STEP_SEQ,
                                    batch=STEP_BATCH)


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=64, batch=8),
    dict(vocab=4096, seq_len=33, batch=3, bigram_weight=0.9, zipf_a=1.05,
         seed=7),
    dict(vocab=50, seq_len=1, batch=5, seed=3)])
def test_token_stream_is_the_references(kw):
    ref = jsyn.TokenStream(jsyn.TokenStreamConfig(**kw))
    mine = tsyn.TokenStream(tsyn.TokenStreamConfig(**kw), device="cpu")
    np.testing.assert_array_equal(mine.successor, ref.successor)
    for step in (0, 1, 17):
        out = mine.batch_at(step)["tokens"]
        assert out.dtype == torch.int32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(ref.batch_at(step)["tokens"]))
    assert tsyn.bigram_entropy(tsyn.TokenStreamConfig(**kw)) == \
        jsyn.bigram_entropy(jsyn.TokenStreamConfig(**kw))


def test_batches_and_stream_iterate_in_step_order():
    stream = tsyn.TokenStream(tsyn.TokenStreamConfig(vocab=64, seq_len=8,
                                                     batch=2), device="cpu")
    batches = Batches(stream, "cpu")
    for step, (a, b) in enumerate(zip(stream, batches)):
        assert torch.equal(a["tokens"], stream.batch_at(step)["tokens"])
        assert torch.equal(b["tokens"], a["tokens"])
        if step == 2:
            break


# ---------------------------------------------------------------------------
# whole steps against repro.core.dist.make_train_step
# ---------------------------------------------------------------------------

def _jax_params():
    return jax.jit(jbuild(_cfg(jconfigs)).init)(jax.random.PRNGKey(0))


def _jax_batches(vocab):
    stream = jsyn.TokenStream(_stream_cfg(jsyn, vocab))
    return [stream.batch_at(i) for i in range(STEPS)]


def _reference_steps(out_path):
    """3 Artemis steps of reduced starcoder2 on a 4-worker mesh (and, for
    the plain step, on one device); run in the subprocess with 4 CPU
    devices."""
    assert jax.device_count() == W, jax.devices()
    model = jbuild(_cfg(jconfigs))
    params = _jax_params()
    batches = _jax_batches(_cfg(jconfigs).vocab)
    mesh = jdist.make_worker_mesh((W,), ("pod",))
    dcfg = jdist.DistConfig(worker_axes=("pod",), **WIRE)
    init_state, step_fn = jdist.make_train_step(model, jsgd(0.05), dcfg, mesh)
    state, jstep, losses = init_state(params), jax.jit(step_fn), []
    for b in batches:
        state, (loss, _) = jstep(state, b)
        losses.append(float(loss))
    out = {"loss": np.asarray(losses),
           "layout": np.asarray(dcfg.layout(params).shape),
           "prev_active": np.asarray(state.artemis.prev_active),
           "h": np.asarray(state.artemis.h),
           "hbar": np.asarray(state.artemis.hbar)}
    for k, v in flatten_params(jax.tree.map(np.asarray,
                                            state.params)).items():
        out[f"param/{k}"] = v
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference_steps(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_mesh") / "steps.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(path)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def test_artemis_steps_match_reference(reference_steps):
    ref = reference_steps
    model = build_model(_cfg(tconfigs))
    params = convert.lm_params(jax.tree.map(np.asarray, _jax_params()),
                               device="cpu")
    dcfg = tdist.DistConfig(**WIRE)
    shape = dcfg.layout(list(params.values())).shape
    assert list(shape) == ref["layout"].tolist()
    init_state, step_fn = tdist.make_train_step(
        model, sgd(0.05), dcfg, W, device="cpu",
        noise=JaxMeshReplay(dcfg.seed, W, shape))
    state, losses = init_state(params), []
    stream = tsyn.TokenStream(_stream_cfg(tsyn, model.cfg.vocab),
                              device="cpu")
    for i in range(STEPS):
        state, (loss, _) = step_fn(state, stream.batch_at(i))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-4)
    flat = np.concatenate([p.numpy().ravel() for p in state.params.values()])
    flat_ref = np.concatenate([ref[f"param/{k}"].ravel()
                               for k in state.params])
    assert_mostly_close(flat, flat_ref, rtol=1e-4, atol=1e-6, frac=1e-3)
    np.testing.assert_allclose(flat, flat_ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(state.artemis.prev_active.numpy(),
                                  ref["prev_active"])
    assert_mostly_close(state.artemis.h.numpy(), ref["h"], rtol=1e-4,
                        atol=1e-6)
    assert_mostly_close(state.artemis.hbar.numpy(), ref["hbar"], rtol=1e-4,
                        atol=1e-6, frac=W * 1e-4)
    assert state.step == STEPS and state.artemis.step == STEPS


def test_plain_step_matches_reference():
    """``make_train_step(..., None)``: the whole batch's gradient, no wire,
    and ``artemis.step + 1``, against the reference's on one device."""
    jm = jbuild(_cfg(jconfigs))
    jp = _jax_params()
    mesh = jdist.make_worker_mesh((1,), ("data",))
    jinit, jstep_fn = jdist.make_train_step(jm, jsgd(0.1), None, mesh)
    jstate, jstep = jinit(jp), jax.jit(jstep_fn)
    model = build_model(_cfg(tconfigs))
    init_state, step_fn = tdist.make_train_step(model, sgd(0.1), None,
                                                device="cpu")
    state = init_state(convert.lm_params(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    stream = tsyn.TokenStream(_stream_cfg(tsyn, model.cfg.vocab),
                              device="cpu")
    for i, jb in enumerate(_jax_batches(model.cfg.vocab)):
        jstate, (jloss, _) = jstep(jstate, jb)
        state, (loss, met) = step_fn(state, stream.batch_at(i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert set(met) == {"nll", "aux"}
    ref = flatten_params(jax.tree.map(np.asarray, jstate.params))
    for k, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert state.step == STEPS and state.artemis.step == STEPS
    assert int(jstate.artemis.step) == STEPS
    # the state holds the reference's leaf-wire stubs
    assert [tuple(h.shape) for h in state.artemis.h] == [(1,)] * len(
        state.params)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

def _train(*extra, arch=ARCH, steps=4):
    return train.main(["--arch", arch, "--reduced", "--steps", str(steps),
                       "--batch", "4", "--seq", "32", "--device", "cpu",
                       "--log-every", "1", *extra])


@pytest.mark.parametrize("arch", ["starcoder2-7b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "recurrentgemma-2b"])
def test_train_cli_trains_each_family(arch):
    """dense, moe, ssm and hybrid: the families the reference's CLI can
    train (its batches carry tokens only)."""
    logs = _train("--dist", "artemis", "--workers", "2", arch=arch, steps=5)
    losses = [r["loss"] for r in logs]
    assert [r["step"] for r in logs] == [1, 2, 3, 4, 5]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("extra", [
    ("--dist", "none"),
    ("--dist", "diana", "--workers", "4", "--optimizer", "sgd", "--lr",
     "0.05"),
    ("--dist", "artemis", "--workers", "2", "--local-steps", "2"),
    ("--dist", "artemis", "--workers", "2", "--participation", "0.5",
     "--straggler-rate", "0.25", "--scrub")])
def test_train_cli_options(extra):
    logs = _train(*extra)
    assert len(logs) == 4 and np.isfinite([r["loss"] for r in logs]).all()
    local = "--local-steps" in extra
    # an accumulate-only step leaves the step count where it was
    assert logs[-1]["step"] == (2 if local else 4)


def test_train_cli_sentinel_rolls_back_then_gives_up(tmp_path):
    """A sentinel below every loss rolls back with lr backoff, each
    recorded in the event log, until it gives up."""
    events = tmp_path / "events.jsonl"
    with pytest.raises(RuntimeError, match="diverged 4 times"):
        _train("--dist", "artemis", "--workers", "2", "--sentinel", "1.0",
               "--events", str(events))
    evs = tevents.read_events(str(events))
    rollbacks = [e for e in evs if e["ev"] == "rollback"]
    assert [e["lr_scale"] for e in rollbacks] == [0.5, 0.25, 0.125]
    assert not tevents.validate_events(evs)


def test_train_cli_events_and_log_file(tmp_path):
    events, log_file = tmp_path / "ev.jsonl", tmp_path / "log.json"
    logs = _train("--dist", "artemis", "--workers", "2", "--events",
                  str(events), "--log-file", str(log_file))
    evs = tevents.read_events(str(events))
    assert not tevents.validate_events(evs)
    kinds = [e["ev"] for e in evs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("train_step") == 4
    spans = {e["name"] for e in evs if e["ev"] == "span"}
    assert spans == {"train/compile+first_step", "train/steady_steps"}
    assert json.loads(log_file.read_text()) == logs
    # the run's kernel launches: none on the CPU (the plain versions)
    assert evs[-1]["kernel_launches"] == {k.__name__: 0 for k in KERNELS}


def test_train_cli_steady_span_leaves_the_saves_out(tmp_path, monkeypatch):
    """``train/steady_steps`` counts the steps after the first and leaves
    the in-loop checkpoint saves out of its time: each save here moves
    the clock on by 1000 s."""
    save, clock, skew = checkpointer.save, time.perf_counter, [0.0]

    def slow_save(*a, **kw):
        skew[0] += 1000.0
        return save(*a, **kw)
    monkeypatch.setattr(checkpointer, "save", slow_save)
    monkeypatch.setattr(time, "perf_counter", lambda: clock() + skew[0])
    events = tmp_path / "ev.jsonl"
    _train("--dist", "artemis", "--workers", "2", "--ckpt-dir",
           str(tmp_path / "c"), "--ckpt-every", "1", "--events", str(events),
           steps=4)
    evs = tevents.read_events(str(events))
    steady = next(e for e in evs if e["ev"] == "span"
                  and e["name"] == "train/steady_steps")
    assert skew[0] == 5000.0            # four in the loop, one after it
    assert steady["steps"] == 3
    assert 0 < steady["dur_s"] < 1000.0


def test_train_cli_resume_is_bit_for_bit(tmp_path):
    """3 steps, a checkpoint, then 3 more resumed, against 6 straight: the
    final checkpoints hold the same bits (parameters, adam's moments, the
    memories, the step counts)."""
    base = ["--dist", "artemis", "--workers", "2"]
    _train(*base, "--ckpt-dir", str(tmp_path / "a"), steps=6)
    _train(*base, "--ckpt-dir", str(tmp_path / "b"), steps=3)
    logs = _train(*base, "--ckpt-dir", str(tmp_path / "b"), "--resume",
                  steps=3)
    assert logs[0]["step"] == 4
    for d in ("a", "b"):
        assert checkpointer.latest_step(str(tmp_path / d)) == 6
    arrays = [np.load(tmp_path / d / "step_00000006" / "arrays.npz")
              for d in ("a", "b")]
    assert sorted(arrays[0].files) == sorted(arrays[1].files)
    assert any(k.startswith("opt_state/m/") for k in arrays[0].files)
    for k in arrays[0].files:
        np.testing.assert_array_equal(arrays[0][k], arrays[1][k], err_msg=k)


def _final(ckpt_dir):
    step = checkpointer.latest_step(str(ckpt_dir))
    return np.load(ckpt_dir / f"step_{step:08d}" / "arrays.npz")


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks start with one intra-op thread, as this module runs
    (they read the environment when torch starts)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("extra", [(), ("--local-steps", "2")])
def test_train_cli_ranks_equal_the_simulated_workers(tmp_path, extra,
                                                     one_thread_ranks):
    base = ["--dist", "artemis", *extra]
    sim = _train(*base, "--workers", "2", "--ckpt-dir", str(tmp_path / "s"))
    pg = _train(*base, "--ranks", "2", "--ckpt-dir", str(tmp_path / "r"))
    assert [r["step"] for r in pg] == [r["step"] for r in sim]
    for a, b in zip(pg, sim):
        assert abs(a["loss"] - b["loss"]) <= 2e-4, (pg, sim)
    ref = _final(tmp_path / "s")
    ranks = [_final(tmp_path / "r" / f"rank{r}") for r in range(2)]
    assert sorted(ranks[0].files) == sorted(ref.files)
    for k in ref.files:
        if k.startswith("artemis/") and ref[k].ndim and k != "artemis/hbar":
            for r, got in enumerate(ranks):          # per-worker state
                np.testing.assert_allclose(got[k][0], ref[k][r], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(ranks[0][k], ref[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_train_cli_ranks_resume_is_bit_for_bit(tmp_path, one_thread_ranks):
    """Over 2 ranks: 2 steps, a checkpoint per rank, then 2 more resumed,
    against 4 straight; each rank's final checkpoint holds the same
    bits."""
    base = ["--dist", "artemis", "--ranks", "2"]
    _train(*base, "--ckpt-dir", str(tmp_path / "a"))
    _train(*base, "--ckpt-dir", str(tmp_path / "b"), steps=2)
    logs = _train(*base, "--ckpt-dir", str(tmp_path / "b"), "--resume",
                  steps=2)
    assert logs[0]["step"] == 3
    for r in range(2):
        a, b = (_final(tmp_path / d / f"rank{r}") for d in ("a", "b"))
        assert int(a["step"]) == int(b["step"]) == 4
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("extra,msg", [
    (("--ranks", "2"), "needs a wire"),
    (("--ranks", "3", "--dist", "artemis"), "does not split"),
    (("--ranks", "2", "--workers", "4", "--dist", "artemis"), "sets W"),
    (("--mesh", "3x2", "--dist", "artemis"), "does not split over 3 data"),
    (("--mesh", "2x2", "--ranks", "2"), "--mesh sets the ranks"),
    (("--mesh", "2x2", "--workers", "3"), "the workers are its 2 data"),
    (("--mesh", "2by2"), "expected DxM")])
def test_train_cli_refuses(extra, msg, capsys):
    with pytest.raises(SystemExit):
        _train(*extra)
    assert msg in capsys.readouterr().err


def test_sharded_batches_are_the_simulated_workers_blocks():
    stream = tsyn.TokenStream(tsyn.TokenStreamConfig(vocab=32, seq_len=8,
                                                     batch=6), device="cpu")
    whole = Batches(stream, "cpu").batch_at(3)
    split = tdist._split(whole, 3)
    for r in range(3):
        got = ShardedBatches(stream, "cpu", rank=r, world=3).batch_at(3)
        assert torch.equal(got["tokens"], split["tokens"][r])
    with pytest.raises(ValueError, match="does not split"):
        ShardedBatches(stream, "cpu", rank=0, world=4).batch_at(0)


def test_serve_cli_and_generate(capsys):
    out = serve.main(["--arch", "mixtral-8x22b", "--reduced", "--device",
                      "cpu"])
    assert tuple(out.shape) == (4, 64) and out.dtype == torch.int32
    assert "tok/s" in capsys.readouterr().out
    cfg = dataclasses.replace(tconfigs.get_config("starcoder2-7b",
                                                  reduced=True),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 5), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    toks, logits = serve.generate(model, params, prompt, 12, 7,
                                  return_logits=True)
    assert torch.equal(toks[:, :5], prompt)
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    # the last decode step's logits are the prefill's over the output
    last = model.prefill_logits(params, {"tokens": toks})
    torch.testing.assert_close(logits, last, rtol=0, atol=1e-4)
    # greedy: each new token is the argmax of the previous step's logits
    assert torch.equal(toks[:, 6], model.prefill_logits(
        params, {"tokens": toks[:, :6]}).argmax(-1).to(torch.int32))


def test_examples_run_on_the_cpu(capsys):
    res = experiments.quickstart(steps=6, device="cpu")
    assert len(res["losses"]) == 6 and res["losses"][-1] < res["losses"][0]
    assert res["wire_bytes"] == [0.0] * 6          # one worker: no ring hop
    cfg = experiments.lm_config(True)
    assert cfg.name == "lm-100m"
    # the reference's fields (the port's own options are at their
    # defaults: test_torch_models.py::test_configs_are_the_references)
    shapes = jax.eval_shape(jbuild(JModelConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(JModelConfig)})).init,
        jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert n == 116_411_136           # the reference's lm-100m, 116.4 M
    out = experiments.serve_lm(device="cpu")
    assert tuple(out.shape) == (4, 40)
    with pytest.raises(RuntimeError, match="did not learn"):
        experiments.train_lm(steps=1, device="cpu")


def _without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["train", "train_ranks", "serve",
                                   "stream", "batches", "init_cache"])
def test_entry_points_need_cuda_unless_cpu(monkeypatch, entry):
    _without_cuda(monkeypatch)
    scfg = tsyn.TokenStreamConfig(vocab=16, seq_len=4, batch=2)
    calls = {
        "train": lambda: train.main(["--arch", ARCH, "--reduced",
                                     "--steps", "1"]),
        "train_ranks": lambda: train.main(["--arch", ARCH, "--reduced",
                                           "--dist", "artemis", "--batch",
                                           "4", "--ranks", "2"]),
        "serve": lambda: serve.main(["--arch", ARCH, "--reduced"]),
        "stream": lambda: tsyn.TokenStream(scfg),
        "batches": lambda: Batches(tsyn.TokenStream(scfg, device="cpu")),
        "init_cache": lambda: build_model(
            tconfigs.get_config(ARCH, reduced=True)).init_cache(1, 4)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_train_help_names_the_missing_mesh(capsys):
    """The mesh is no longer missing: the help describes it, and no option
    overrides the backend that the device picks."""
    with pytest.raises(SystemExit):
        train.main(["--help"])
    out = capsys.readouterr().out
    assert "--mesh" in out and "DxM" in out and "--backend" not in out
    assert "not ported" not in out


if __name__ == "__main__":
    _reference_steps(sys.argv[1])
