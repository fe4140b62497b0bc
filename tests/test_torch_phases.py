"""The step's phases (``repro_torch/obs/spans.py::phase``) in the port's
models and wire, on the CPU: a capture changes no bit of an Artemis step
(remat on), and its log reads forward, then backward with the recompute
inside it, nested as the step runs."""
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import dist
from repro_torch.models.model import build_model
from repro_torch.obs import spans
from repro_torch.optim import adam

# an encoder-decoder and a decoder-only model, at the port's REDUCED widths
ARCHS = ("whisper-tiny", "starcoder2-7b")
WIRE = ("wire/bucketize", "wire/noise", "wire/memory", "wire/encode",
        "wire/ring", "wire/decode", "wire/memory", "wire/downlink",
        "wire/unbucketize")
BLOCKS = ("grads/attention", "grads/mlp", "grads/head")


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _steps(arch: str, capture: bool, n: int = 2):
    cfg = dataclasses.replace(get_config(arch, reduced=True), remat=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(4, cfg.n_frames, cfg.d_model,
                                      generator=g)
    dcfg = dist.DistConfig(seed=5, bucket_bytes=4096, max_buckets=16,
                           bucket_row=64)
    init, step = dist.make_train_step(model, adam(1e-3), dcfg, 2,
                                      torch.device("cpu"))
    state, losses = init(params), []
    spans.reset()
    with (profile(activities=[ProfilerActivity.CPU]) if capture
          else contextlib.nullcontext()):
        for _ in range(n):
            state, (loss, _) = step(state, batch)
            losses.append(loss)
    return losses, state, spans.phases()


@pytest.mark.parametrize("arch", ARCHS)
def test_a_capture_changes_no_bit_of_the_step(arch):
    plain, s0, recs0 = _steps(arch, capture=False)
    traced, s1, recs1 = _steps(arch, capture=True)
    assert recs0 == [] and recs1
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k]), k
    assert torch.equal(s0.artemis.h, s1.artemis.h)
    assert torch.equal(s0.artemis.hbar, s1.artemis.hbar)


def _encloses(outer, inner) -> bool:
    return outer.seq < inner.seq and inner.end_seq < outer.end_seq


@pytest.mark.parametrize("arch", ARCHS)
def test_the_log_reads_forward_then_backward_with_the_recompute_inside(arch):
    _, _, recs = _steps(arch, capture=True, n=1)
    assert all(r.end_seq > r.seq >= 0 for r in recs)
    step, grads = recs[0], recs[1]
    assert (step.name, step.step, step.parent) == ("step", 0, None)
    assert (grads.name, grads.parent) == ("grads", "step")
    assert all(r.step == 0 and _encloses(step, r) for r in recs[1:])
    inner = [r for r in recs if _encloses(grads, r)]
    assert {r.name for r in inner} == set(BLOCKS) | {"grads/recompute"}
    # forward until the loss's backward begins (the head's, first), then
    # backward, the recompute inside it
    first_bwd = next(i for i, r in enumerate(inner) if r.pass_ == "backward")
    assert inner[first_bwd].name == "grads/head"
    assert {r.pass_ for r in inner[:first_bwd]} == {"forward"}
    assert {r.pass_ for r in inner[first_bwd:]} == {"backward", "recompute"}
    for r in inner[first_bwd:]:
        if r.name == "grads/recompute":
            assert (r.pass_, r.end_pass, r.parent) == ("recompute",
                                                       "backward", "grads")
        elif r.pass_ == "recompute":
            assert r.parent == "grads/recompute"
        else:
            assert (r.pass_, r.end_pass, r.parent) == ("backward",
                                                       "backward", "grads")
    # every block has its backward; every layer's blocks are recomputed
    for name in BLOCKS:
        by = [r.pass_ for r in inner if r.name == name]
        assert by.count("forward") == by.count("backward") >= 1
        assert by.count("recompute") == (0 if name == "grads/head"
                                         else by.count("forward"))
    # the blocks' backward records nest: each closes before the next opens
    bwd = sorted((r for r in inner if r.pass_ != "forward"),
                 key=lambda r: r.seq)
    for a, b in zip(bwd, bwd[1:]):
        assert a.end_seq < b.seq or _encloses(a, b)
    # then the wire, in the order it runs, and the optimizer
    after = [r for r in recs[2:] if not _encloses(grads, r)]
    assert [r.name for r in after] == list(WIRE) + ["optim", "optim/apply"]
    assert all(r.pass_ == r.end_pass == "forward" for r in after)
    assert after[-1].parent == "optim" and _encloses(after[-2], after[-1])
    assert after[WIRE.index("wire/ring")].counts["wire_bytes"] > 0
