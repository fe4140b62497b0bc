"""The port's work-per-round contract (stands for
``repro/analysis/trace_audit.py``).

The reference's contract is "one compile for the whole grid": a sweep
compiles once, however many cells it holds.  The port runs eagerly and
compiles nothing, so its contract is the eager one: a round's work does not
grow with the number of cells.  Each round of a variant is one pass of
batched tensor ops over all of its cells; a change that loops over cells
in Python would multiply the ops a round issues, and every host-bound time
in PERF.md with them.

Mechanics: ``OpCounter``, a ``TorchDispatchMode``, counts the aten ops
dispatched inside it, on any device (so the audit runs on the CPU).  The
hand-written kernels are launched through ctypes, invisible to dispatch,
so on the card the audit adds their launch counts (``kernels.KERNELS``)
to the aten count.  Ops per round is the difference between a run of
``2 R`` and of ``R`` rounds, over ``R``: set-up and read-out cancel.

Entry points audited:

  sweep_grid          ``run_sweep`` over 2 variants x 2 step sizes at 2
                      and at 4 seeds (8 and 16 cells): equal ops a round.
                      The noise source's per-seed draws come once every
                      ``TorchNoise.CHUNK`` (64) rounds, outside the count.
  artemis_round_dense ``artemis_round`` over 3 rounds with 8 and 16 cells
  artemis_round_cuda    on its leading axis, each backend: equal ops.
  bucket_ring         the bucketed pipelined mesh step (ToyMLP(2, 32), W =
                      4): its 3 steps after a warm-up issue equal ops.

``audit_no_growth(run, sizes, entry)`` is the reusable core: the tests use
it to show that the audit flags a per-cell loop.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import default_device
from repro_torch.analysis.findings import Finding

RULES = {
    "launch-growth": "error",       # a round's work grows with the cells
    "launch-entry-error": "error",  # an entry point raised while audited
}


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active (``counts`` by
    op name, ``total``)."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))

    @property
    def total(self) -> int:
        return sum(self.counts.values())


def _launches() -> int:
    from repro_torch.kernels import KERNELS
    return sum(k.launches for k in KERNELS)


def count_work(fn: Callable[[], object]) -> int:
    """Aten ops plus kernel launches of one call of ``fn``."""
    before = _launches()
    with OpCounter() as c:
        fn()
    return c.total + _launches() - before


def per_round(run: Callable[[int], object], rounds: int) -> float:
    """Work a round: ``run(2 R)`` minus ``run(R)``, over R."""
    return (count_work(lambda: run(2 * rounds))
            - count_work(lambda: run(rounds))) / rounds


def audit_no_growth(work: Callable[[int], float], sizes: Sequence[int],
                    entry: str) -> List[Finding]:
    """``work(size)`` is the work a round at ``size`` cells; a finding
    unless it is the same at every size."""
    got = {n: work(n) for n in sizes}
    if len(set(got.values())) == 1:
        return []
    return [Finding(
        rule="launch-growth", severity="error", path=entry, line=0,
        message=f"ops a round by cells: {got}; a round's work must not grow "
                f"with the number of cells (a per-cell loop is back)")]


# ---------------------------------------------------------------------------
# registered entry points
# ---------------------------------------------------------------------------

def _audit_sweep_grid(device) -> List[Finding]:
    from repro_torch.core import artemis as art
    from repro_torch.core import federated as fed
    from repro_torch.core import sweep as sw

    n, d = 4, 8
    prob, _ = fed.make_lsr_problem(0, n_workers=n, n_per=20, d=d, noise=0.3,
                                   device=device)
    cfgs = [art.variant_config(v, d, n, p=0.7) for v in ("sgd", "artemis")]

    def work(cells):
        seeds = list(range(cells // 4))      # 2 variants x 2 step sizes
        return per_round(lambda r: sw.run_sweep(
            prob, cfgs, [0.01, 0.02], seeds, r, batch=2, eval_every=r,
            device=device), 4)
    return audit_no_growth(work, (8, 16), "sweep_grid")


def _audit_artemis(device, backend: str) -> List[Finding]:
    from repro_torch.core import artemis as art

    d, n = 16, 4
    cfg = art.variant_config("artemis", d, n, s=1, p=0.5)

    def work(cells):
        gen = torch.Generator(device=device).manual_seed(3)

        def run(rounds):
            st = art.init_state(cfg, (cells,), device=device)
            for _ in range(rounds):
                grads = torch.randn(cells, n, d, generator=gen, device=device)
                act = (torch.rand(cells, n, generator=gen, device=device)
                       < 0.5).float()
                _, st, _ = art.artemis_round(
                    cfg, st, grads, torch.rand(cells, n, d, generator=gen,
                                               device=device),
                    torch.rand(cells, d, generator=gen, device=device), act,
                    backend=backend)
        return per_round(run, 3)
    return audit_no_growth(work, (8, 16), f"artemis_round_{backend}")


def _audit_bucket_ring(device) -> List[Finding]:
    from repro_torch.core import dist
    from repro_torch.models.toy import ToyMLP
    from repro_torch.optim import sgd

    w = 4
    model = ToyMLP(2, 32).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=4 * w)
    dcfg = dist.DistConfig(variant="artemis", s=3, wire="bucketed",
                           reduce_impl="pipelined")
    init_state, step_fn = dist.make_train_step(model, sgd(0.05), dcfg, w,
                                               device=device)
    state = [init_state(params)]

    def step():
        state[0], _ = step_fn(state[0], batch)

    step()                                   # the first step sets up
    steps = {i: count_work(step) for i in range(1, 4)}
    if len(set(steps.values())) == 1:
        return []
    return [Finding(
        rule="launch-growth", severity="error", path="bucket_ring", line=0,
        message=f"ops a step of the pipelined ring after the first: "
                f"{steps}; equal steps must issue equal work")]


ENTRY_POINTS: Dict[str, Callable] = {
    "sweep_grid": _audit_sweep_grid,
    "artemis_round_dense": lambda dev: _audit_artemis(dev, "dense"),
    "artemis_round_cuda": lambda dev: _audit_artemis(dev, "cuda"),
    "bucket_ring": _audit_bucket_ring,
}


def audit_entry_points(device=None) -> List[Finding]:
    dev = default_device(device)
    findings: List[Finding] = []
    for name, fn in ENTRY_POINTS.items():
        try:
            findings.extend(fn(dev))
        except Exception as e:  # noqa: BLE001 (a boundary: report, go on)
            findings.append(Finding(
                rule="launch-entry-error", severity="error", path=name,
                line=0, message=f"entry point raised {type(e).__name__}: {e}"))
    return findings
