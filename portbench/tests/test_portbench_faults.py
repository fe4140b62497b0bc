"""The check catches what it is there to catch: a whole run of each cell at
its CPU size (``tests/sizes/``; the harness's look for a card skipped), with
the program's timed path broken underneath, comes out not correct under
the cell's own limits; so does the control, the reference put in the
program's place through float8 products.  The sound program comes out
correct.  Each cell runs through its own runner."""
import time

import pytest
import torch

from portbench import bench, check
from portbench.tests.conftest import ROOT, SIZED_CELLS, reduced_cell

CPU = torch.device("cpu")
SEED = 2**31 + 23


def _runner(cell):
    return bench.runner(cell.traffic["runner"], cell.root)


def _run(cell):
    return _runner(cell).run(bench.Run(
        cell=cell, seed=SEED, seconds=0.05, trace=False, device=CPU,
        t0=time.perf_counter()))


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.core import dist
    make = dist.make_train_step

    def broken(*args, **kw):
        init_state, step_fn = make(*args, **kw)

        def step(state, batch):
            return state, step_fn(state, batch)[1]
        return init_state, step

    monkeypatch.setattr(dist, "make_train_step", broken)


def _half_batch(monkeypatch):
    """Half of each worker's rows left out, the mean over the rest."""
    from repro_torch.models.model import Model
    loss = Model.loss

    def broken(self, params, batch):
        n = batch["tokens"].shape[0] // 2
        return loss(self, params, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(Model, "loss", broken)


def _no_exchange(monkeypatch):
    """The ring left out: worker 0's sum holds its own message alone."""
    from repro_torch.core import dist
    monkeypatch.setattr(dist.SimulatedAxis, "ring",
                        lambda self, codec, payload: codec.decode(
                            payload)[0])


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


def _has(fault, cell):
    """Whether the cell can have the fault: an exchange needs a wire with
    more than one worker."""
    tr = bench.load_cell(cell, ROOT).traffic
    return fault != "no_exchange" or bool(tr["wire"] and tr["workers"] > 1)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SIZED_CELLS
                                        for f in sorted(FAULTS)
                                        if _has(f, c)])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    c = reduced_cell(cell)
    FAULTS[fault](monkeypatch)
    out = _run(c)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", SIZED_CELLS)
def test_the_sound_program_is_correct(cell):
    out = _run(reduced_cell(cell))
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", SIZED_CELLS)
def test_the_control_is_not_correct(cell):
    c = reduced_cell(cell)
    ref = _runner(c).reference_readings(c, SEED, CPU)
    control = _runner(c).reference_readings(c, SEED, CPU, precision="fp8")
    ok, checks = check.judge(check.gaps(control, ref), c.limits)
    assert ok is False, checks
