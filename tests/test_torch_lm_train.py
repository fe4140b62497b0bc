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
    stop.

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
from repro_torch.data.pipeline import Batches
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
    shapes = jax.eval_shape(jbuild(JModelConfig(**dataclasses.asdict(
        cfg))).init, jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert n == 116_411_136           # the reference's lm-100m, 116.4 M
    out = experiments.serve_lm(device="cpu")
    assert tuple(out.shape) == (4, 40)
    with pytest.raises(RuntimeError, match="did not learn"):
        experiments.train_lm(steps=1, device="cpu")


def _without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["train", "serve", "stream", "batches",
                                   "init_cache"])
def test_entry_points_need_cuda_unless_cpu(monkeypatch, entry):
    _without_cuda(monkeypatch)
    scfg = tsyn.TokenStreamConfig(vocab=16, seq_len=4, batch=2)
    calls = {
        "train": lambda: train.main(["--arch", ARCH, "--reduced",
                                     "--steps", "1"]),
        "serve": lambda: serve.main(["--arch", ARCH, "--reduced"]),
        "stream": lambda: tsyn.TokenStream(scfg),
        "batches": lambda: Batches(tsyn.TokenStream(scfg, device="cpu")),
        "init_cache": lambda: build_model(
            tconfigs.get_config(ARCH, reduced=True)).init_cache(1, 4)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_train_help_names_the_missing_mesh(capsys):
    with pytest.raises(SystemExit):
        train.main(["--help"])
    assert "--mesh" in capsys.readouterr().out


if __name__ == "__main__":
    _reference_steps(sys.argv[1])
