"""The sweep engine and the mesh wire (port of ``benchmarks/dist_bench.py``),
three suites:

  * ``sweep_engine``: the legacy per-cell loop (``federated.run_percell``,
    one cell at a time, the full loss every round) against ``run_sweep``
    (every cell of a variant batched), cold and warm, and
    ``group_by_variant=True`` on the paper's grid (6 variants x 4 step sizes
    x 3 seeds, 200 rounds).  The reference's ``traces_*`` (compiles) have no
    counterpart in an eager port; in their place, the work one round issues:
    device kernels a round from a profiled run on the card, aten ops
    dispatched a round on the CPU (``analysis.launch_audit``).
  * ``bucketed_ring``: the bucketed wire against the leaf wire, one
    artemis train step of ToyMLP(12, 64) on W = 8 simulated workers of one
    device (the reference's ``bucket_ring_bench.bench_wire``, in process),
    with the payload bytes by dtype that crossed the ring counted from its
    tensors (``analysis.wire_checks.CountingAxis``) against
    ``launch/roofline.py``'s wire models: they must match exactly.
  * ``dist_step``: reduced starcoder2 through ``dist.make_train_step`` for
    none (the plain data-parallel step), sgd, qsgd and artemis, with the
    analytic bytes a worker a step (``_wire_bytes``).

Reports go to ``bench_sweep.json`` and ``bench_dist.json`` under the
context's directory, never to the reference's files.
"""
from __future__ import annotations

import json
import time
from typing import List

import torch

from repro_torch.bench import Context, Row, host_us, sync
from repro_torch.core import artemis as art
from repro_torch.core import dist
from repro_torch.core import federated as fed
from repro_torch.core import sweep as sw

VARIANTS = ["sgd", "qsgd", "diana", "biqsgd", "artemis", "dore"]
GAMMA_FRACS = [0.125, 0.25, 0.5, 1.0]
SEEDS = [0, 1, 2]
ITERS = 200
EVAL_EVERY = 10


def ops_per_round(run, ctx: Context, rounds: int = 4):
    """(ops a round, what they are): device kernels from the profiler's
    trace on the card, dispatched aten ops on the CPU; ``run(R)`` minus
    ``run(2 R)``'s work over R, so set-up cancels."""
    if not ctx.cuda:
        from repro_torch.analysis.launch_audit import per_round
        return per_round(run, rounds), "aten ops dispatched a round (cpu)"
    cuda = torch.autograd.DeviceType.CUDA

    def kernels(r):
        run(r)                          # warm: nothing is counted twice
        sync(ctx.device)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(r)
            sync(ctx.device)
        return sum(1 for e in prof.events() if e.device_type == cuda)
    return ((kernels(2 * rounds) - kernels(rounds)) / rounds,
            "device kernels a round (torch.profiler)")


def _seconds(fn, ctx: Context) -> float:
    """Host seconds of ``fn()``, ending in a synchronize."""
    t0 = time.perf_counter()
    fn()
    sync(ctx.device)
    return time.perf_counter() - t0


def sweep_engine_suite(ctx: Context) -> List[Row]:
    """The per-cell loop against the batched engine on one grid."""
    n, d, dev = 20, 20, ctx.device
    variants = VARIANTS[:1] if ctx.fast else VARIANTS
    fracs = GAMMA_FRACS[:1] if ctx.fast else GAMMA_FRACS
    seeds = SEEDS[:1] if ctx.fast else SEEDS
    iters = 20 if ctx.fast else ITERS
    every = 1 if ctx.fast else EVAL_EVERY
    prob, _ = fed.make_lsr_problem(11, n_workers=n, n_per=200, d=d,
                                   noise=0.4, device=dev)
    cfgs = [art.variant_config(v, d, n) for v in variants]
    g_ref = fed.gamma_max(prob, art.variant_config("artemis", d, n))
    gammas = [f * g_ref for f in fracs]
    cells = len(cfgs) * len(gammas) * len(seeds)

    def percell(r=iters):
        for cfg in cfgs:
            for g in gammas:
                for s in seeds:
                    fed.run_percell(prob, cfg, g, r, s, batch=1)

    def sweep(group=False, r=iters):
        return sw.run_sweep(prob, cfgs, gammas, seeds, r, batch=1,
                            eval_every=every if r == iters else r,
                            group_by_variant=group, device=dev)

    percell_s = _seconds(percell, ctx)
    cold_s = _seconds(sweep, ctx)
    warm_s = _seconds(sweep, ctx)
    gcold_s = _seconds(lambda: sweep(True), ctx)
    gwarm_s = _seconds(lambda: sweep(True), ctx)
    ops_cell, what = ops_per_round(percell, ctx)
    ops_grid, _ = ops_per_round(lambda r: sweep(r=r), ctx)
    ops_group, _ = ops_per_round(lambda r: sweep(True, r), ctx)
    report = {
        "grid": {"variants": variants, "n_gammas": len(gammas),
                 "n_seeds": len(seeds), "cells": cells, "iters": iters,
                 "eval_every": every, "n_workers": n, "dim": d},
        "percell_wall_s": round(percell_s, 3),
        "sweep_cold_wall_s": round(cold_s, 3),
        "sweep_warm_wall_s": round(warm_s, 3),
        "speedup_cold": round(percell_s / cold_s, 2),
        "speedup_warm": round(percell_s / warm_s, 2),
        "cells_per_sec_warm": round(cells / warm_s, 2),
        "grouped_cold_wall_s": round(gcold_s, 3),
        "grouped_warm_wall_s": round(gwarm_s, 3),
        "ops_per_round": {"percell": ops_cell, "sweep": ops_grid,
                          "grouped": ops_group, "what": what},
        "device": _device_name(ctx), "torch": torch.__version__,
    }
    with open(ctx.path("bench_sweep.json"), "w") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    per = 1e6 / (cells * iters)
    return [
        ("sweep/percell_loop", percell_s * per,
         f"wall_s={percell_s:.2f} ops_per_round={ops_cell:g} (all "
         f"{cells} cells, one at a time; {what})"),
        ("sweep/engine_cold", cold_s * per,
         f"wall_s={cold_s:.2f} speedup={percell_s / cold_s:.1f}x"),
        ("sweep/engine_warm", warm_s * per,
         f"wall_s={warm_s:.2f} ops_per_round={ops_grid:g} "
         f"speedup={percell_s / warm_s:.1f}x"),
        ("sweep/grouped_cold", gcold_s * per, f"wall_s={gcold_s:.2f}"),
        ("sweep/grouped_warm", gwarm_s * per,
         f"wall_s={gwarm_s:.2f} ops_per_round={ops_group:g} "
         f"vs_batched_warm={warm_s / gwarm_s:.2f}x")]


def _device_name(ctx: Context) -> str:
    return (torch.cuda.get_device_name(ctx.device) if ctx.cuda
            else "cpu")


def bench_wire(ctx: Context, wire: str, model, params, batch, workers: int,
               steps: int) -> dict:
    """One wire's train step: µs a step (host clock, ending in a
    synchronize), its bytes by dtype counted on the ring against the wire
    model."""
    from repro_torch.analysis import wire_checks as wc
    from repro_torch.launch import roofline
    from repro_torch.optim import sgd
    dcfg = dist.DistConfig(variant="artemis", s=3, wire=wire,
                           bucket_bytes=4096, max_buckets=16, bucket_row=64)
    init_state, step_fn = dist.make_train_step(model, sgd(0.05), dcfg,
                                               workers, device=ctx.device)
    state = [init_state(params)]

    def step():
        state[0], out = step_fn(state[0], batch)
        return out

    for _ in range(2):                                   # warm-up
        step()
    sync(ctx.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, _ = step()
    loss = float(loss)
    step_us = (time.perf_counter() - t0) / steps * 1e6
    shapes = [tuple(p.shape) for p in params.values()]
    measured = wc.measure_wire(dcfg, shapes, workers, ctx.device)
    model_b = wc.model_bytes(dcfg, shapes, workers)
    ok = not wc.wire_findings(measured, model_b, wire,
                              payload_f32_bytes=4.0 * sum(
                                  p.numel() for p in params.values()))
    if wire == "bucketed":
        lay = dcfg.layout(shapes)
        mdl = roofline.bucketed_wire_model(
            n_workers=workers, n_buckets=lay.n_buckets, rows=lay.rows,
            row=lay.row)
        extra = {"layout": {"n_buckets": lay.n_buckets, "rows": lay.rows,
                            "row": lay.row, "pad": lay.pad}}
    else:
        mdl = roofline.leaf_wire_model(shapes, n_workers=workers)
        extra = {"n_leaves": len(shapes)}
    return {"step_us": round(step_us, 1), "final_loss": loss,
            "ring_bytes_by_dtype": {f"{op}/{dt}": b
                                    for (op, dt), b in sorted(
                                        measured.items())},
            "model": {k: v for k, v in mdl.items()},
            "wire_guard": {"ok": ok, "model_bytes_by_dtype": {
                f"{op}/{dt}": b for (op, dt), b in sorted(model_b.items())}},
            **extra}


def bucketed_ring_suite(ctx: Context) -> List[Row]:
    """Bucketed against leaf wire, one step each, W simulated workers."""
    from repro_torch.models.toy import ToyMLP
    workers = 4 if ctx.fast else 8
    steps = 3 if ctx.fast else 10
    model = ToyMLP(6 if ctx.fast else 12, 64).to(ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=4 * workers)
    wires = {w: bench_wire(ctx, w, model, params, batch, workers, steps)
             for w in ("leaf", "bucketed")}
    speedup = round(wires["leaf"]["step_us"] / wires["bucketed"]["step_us"],
                    2)
    report = {"workers": workers, "fast": ctx.fast, "steps_timed": steps,
              "model": {"n_layers": model.n_layers, "d": model.d,
                        "n_leaves": len(params),
                        "n_params": int(sum(p.numel()
                                            for p in params.values()))},
              "wires": wires, "speedup_bucketed_vs_leaf": speedup,
              "device": _device_name(ctx), "torch": torch.__version__}
    path = ctx.path("bench_dist.json")
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    rows = []
    for w in ("leaf", "bucketed"):
        r = wires[w]
        s8 = r["ring_bytes_by_dtype"].get("ring/s8", 0)
        rows.append((f"bucket_ring/{w}", r["step_us"],
                     f"ring_s8_bytes={s8:.0f} wire_guard_ok="
                     f"{r['wire_guard']['ok']} (host clock, "
                     f"{_device_name(ctx)})"))
    guard = all(wires[w]["wire_guard"]["ok"] for w in wires)
    rows.append(("bucket_ring/speedup", 0.0,
                 f"bucketed_vs_leaf={speedup}x wire_guard_ok={guard}"))
    if not guard:
        raise AssertionError(f"the ring's bytes differ from the wire model: "
                             f"{[wires[w]['wire_guard'] for w in wires]}")
    return rows


def _wire_bytes(params, variant: str, n_workers: int) -> float:
    """Analytic inter-worker bytes a worker a step, uplink plus downlink
    (the reference's ``dist_bench._wire_bytes``)."""
    leaves = list(params.values())
    total_f32 = sum(p.numel() * 4 for p in leaves)
    total_int8 = sum(p.numel() for p in leaves)
    scales = sum((p.numel() // p.shape[-1] if p.dim() else 1) * 4
                 for p in leaves)
    ring_f32 = 2 * (n_workers - 1) / n_workers * total_f32     # all-reduce
    ring_q = (n_workers - 1) * (total_int8 + scales) / n_workers
    if variant == "sgd":
        return ring_f32
    dwn = 0.0 if variant in ("biqsgd", "artemis") else ring_f32 / 2
    return ring_q + dwn


def dist_step_suite(ctx: Context) -> List[Row]:
    """Reduced starcoder2 through the train step, every variant."""
    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.optim import sgd
    cfg = configs.get_config("starcoder2-7b", reduced=True)
    model = build_model(cfg)
    dev = ctx.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    b, s = (4, 32) if ctx.fast else (8, 128)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (b, s), generator=torch.Generator(
            device=dev).manual_seed(1), device=dev, dtype=torch.int32)}
    workers = 2 if ctx.fast else 4
    rows = []
    for variant in ["none", "sgd", "qsgd", "artemis"]:
        dcfg = None if variant == "none" else dist.DistConfig(
            variant=variant)
        init_state, step_fn = dist.make_train_step(model, sgd(0.01), dcfg,
                                                   workers, device=dev)
        state = [init_state(params)]

        def step():
            state[0], _ = step_fn(state[0], batch)

        us = host_us(step, dev, reps=1 if ctx.fast else 3)
        wire = _wire_bytes(params, "sgd" if variant == "none" else variant,
                           workers)
        rows.append((f"dist_step/{variant}", us,
                     f"wire_bytes_per_worker={wire:.3e} workers={workers} "
                     f"(host clock, {_device_name(ctx)})"))
    return rows


SUITES = [("sweep_engine", sweep_engine_suite),
          ("bucketed_ring", bucketed_ring_suite),
          ("dist_step", dist_step_suite)]
