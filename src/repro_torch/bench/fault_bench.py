"""The fault defenses' cost (port of ``benchmarks/fault_bench.py``).

  * ``fault_overhead`` (a suite): the bucketed mesh step's time with the
    finite and checksum scrubbing on against off, on W simulated workers
    (ToyMLP(4, 256), artemis, s = 3, p = 0.7), as paired back-to-back
    measurements, the median of the pairs' ratios, against the
    reference's 5 % budget.  The budget is reported, not enforced: a miss
    is a finding for ``PERF.md``.  Beside it, informational, the sweep's
    walls with scrubbing and with the full defense (scrub, bit flips, the
    sentinel) on a toy grid, whose rounds are so small that the relative
    cost is inflated.
  * ``python -m repro_torch.bench.fault_bench --matrix [--device D]``: the
    recovery checks of ``experiments.fault_matrix``; exits 1 on a failed
    recovery.

The step and the sweep are timed on the host clock, ending in a
synchronize (on the card, a synchronize of the device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import torch

from repro_torch.bench import Context, Row, sync
from repro_torch.core import artemis as art
from repro_torch.core import dist
from repro_torch.core import faults
from repro_torch.core import federated as fed
from repro_torch.core import sweep as sw

OVERHEAD_BUDGET_PCT = 5.0


def mesh_step_us(ctx: Context, scrub: bool) -> float:
    """Best over short runs of the bucketed mesh step, in µs a step."""
    from repro_torch.models.toy import ToyMLP
    from repro_torch.optim import sgd
    workers = 4 if ctx.fast else 8
    model = ToyMLP(4, 256).to(ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=32)
    dcfg = dist.DistConfig(
        variant="artemis", s=3, p_participation=0.7, wire="bucketed",
        bucket_row=64, faults=faults.FaultConfig(scrub=True) if scrub
        else None)
    init_state, step_fn = dist.make_train_step(model, sgd(0.05), dcfg,
                                               workers, device=ctx.device)
    state = init_state(params)
    state, _ = step_fn(state, batch)
    sync(ctx.device)
    reps, iters = (2, 5) if ctx.fast else (8, 10)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step_fn(state, batch)
        sync(ctx.device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e6


def sweep_walls(ctx: Context):
    """(cells, rounds, wall s without defenses, with scrubbing, with the
    full defense) of a toy grid, best of 3 after a warm run."""
    n, d = 20, 20
    iters = 20 if ctx.fast else 200
    prob, _ = fed.make_lsr_problem(11, n_workers=n, n_per=200, d=d,
                                   noise=0.4, device=ctx.device)
    variants = ["artemis"] if ctx.fast else ["qsgd", "artemis", "dore"]

    def timed(fc):
        cfgs = [dataclasses.replace(art.variant_config(v, d, n, p=0.7),
                                    faults=fc) for v in variants]

        def run():
            sw.run_sweep(prob, cfgs, [0.02, 0.05], [0, 1], iters, batch=4,
                         eval_every=1 if ctx.fast else 10,
                         device=ctx.device)
        run()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best

    return (len(variants) * 4, iters, timed(None),
            timed(faults.FaultConfig(scrub=True)),
            timed(faults.FaultConfig(bitflip_rate=0.01, scrub=True,
                                     sentinel=1e6)))


def fault_overhead_suite(ctx: Context) -> List[Row]:
    """Scrubbing's cost: the mesh step (5 % budget) and the sweep
    (informational)."""
    pairs = [(mesh_step_us(ctx, False), mesh_step_us(ctx, True))
             for _ in range(1 if ctx.fast else 3)]
    pairs.sort(key=lambda p: (p[1] - p[0]) / p[0])
    base_us, scrub_us = pairs[len(pairs) // 2]
    pct = (scrub_us - base_us) / base_us * 100.0
    cells, iters, base_s, scrub_s, full_s = sweep_walls(ctx)
    ok = pct < OVERHEAD_BUDGET_PCT
    per = 1e6 / (cells * iters)
    return [
        ("fault/mesh_step", base_us, "bucketed wire, defenses off"),
        ("fault/mesh_step_scrub", scrub_us,
         f"overhead={pct:+.1f}% budget<{OVERHEAD_BUDGET_PCT:.0f}% ok={ok} "
         f"(median of {len(pairs)} pairs; reported, not enforced)"),
        ("fault/sweep_scrub", scrub_s * per,
         f"toy-round overhead={(scrub_s - base_s) / base_s * 100:+.1f}% "
         "(informational)"),
        ("fault/sweep_full_defense", full_s * per,
         f"scrub+flip+sentinel wall_s={full_s:.3f}")]


SUITES = [("fault_overhead", fault_overhead_suite)]


def main(argv=None) -> int:
    import argparse
    import json
    from repro_torch import default_device
    from repro_torch import experiments as ex
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.fault_bench",
        description="the fault model's recovery checks (--matrix)")
    ap.add_argument("--matrix", action="store_true", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    res = ex.fault_matrix(default_device(args.device))
    checks = ("identity", "scrub", "sentinel", "bitflip")
    print(json.dumps(res))  # repro-lint: allow=print-in-library (CLI)
    if all(res[c] for c in checks):
        print("fault matrix: OK (identity, scrub, sentinel, bitflip)")  # repro-lint: allow=print-in-library (CLI)
        return 0
    print("fault matrix: FAILED", [c for c in checks if not res[c]])  # repro-lint: allow=print-in-library (CLI)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
