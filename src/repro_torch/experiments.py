"""The paper's headline experiments on the port (``examples/federated_artemis.py``
exp1 to exp5 and ``benchmarks/paper_figs.py``'s ``fig4_bits``,
``table3_gamma_max`` and ``thm3_variance_lower_bound``), at the reference's
N, d, iterations and step sizes; the fault model's recovery checks
(``fault_matrix``, as ``benchmarks/fault_bench.py::run_matrix``); the mesh
wire's training run (``toy_mesh_train``), one step of compressed SGD
through the ops API (``compressed_sgd_step``), and the language-model
examples (``examples/quickstart.py``, ``train_lm.py``, ``serve_lm.py``:
``quickstart``, ``train_lm``, ``serve_lm``).  Each returns its numbers;
none prints but the CLI, ``python -m repro_torch.experiments <name>``.

Every function runs on ``device`` (CUDA unless the caller passes another)
with ``backend="cuda"``, so the squant uplinks go through the fused kernels
(their plain versions on CPU tensors).  The problems are drawn from the
port's own generators, so their data differ from the reference's; the
claims do not depend on them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core import artemis as art
from repro_torch.core import dist
from repro_torch.core import faults
from repro_torch.core import federated as fed
from repro_torch.core import sweep as sw
from repro_torch.kernels import ops
from repro_torch.kernels.bucket_ring import bucket_acc, bucket_ring_sum
from repro_torch.models.toy import ToyMLP
from repro_torch.optim import sgd

N, D = 20, 20


def _timed_sweep(prob, cfgs, gammas, seeds, iters, **kw):
    """run_sweep plus its wall time in microseconds per round per cell (the
    host clock around work that ends in a copy to the host)."""
    t0 = time.perf_counter()
    res = sw.run_sweep(prob, cfgs, gammas, seeds, iters, device=prob.device,
                       backend="cuda", **kw)
    dt = time.perf_counter() - t0
    cells = len(cfgs) * len(gammas) * len(seeds)
    return res, dt * 1e6 / (iters * cells)


def exp1_saturation(device=None) -> Dict:
    """Fig 3a: i.i.d. LSR with sigma_* != 0: every variant saturates, double
    compression above single, above SGD (Thm 1)."""
    dev = default_device(device)
    prob, _ = fed.make_lsr_problem(0, n_workers=N, n_per=200, d=D, noise=0.4,
                                   device=dev)
    opt = float(prob.global_loss(prob.solve_opt()))
    gamma = 0.8 * fed.gamma_max(prob, art.variant_config("artemis", D, N))
    variants = ["sgd", "qsgd", "diana", "biqsgd", "artemis"]
    cfgs = [art.variant_config(v, D, N) for v in variants]
    res, us = _timed_sweep(prob, cfgs, [gamma], [0], 3000, batch=1,
                           eval_every=10)
    sat = {v: float(np.mean(res.losses[vi, 0, 0, -30:])) - opt
           for vi, v in enumerate(variants)}
    return {"saturation": sat, "us_per_round_cell": us}


def exp2_linear(device=None) -> Dict:
    """Fig S8: sigma_* == 0: linear convergence for every variant, each at
    its own gamma_max (the diagonal of a variant x gamma grid)."""
    dev = default_device(device)
    prob, _ = fed.make_lsr_problem(0, n_workers=N, n_per=200, d=D, noise=0.0,
                                   device=dev)
    variants = ["sgd", "qsgd", "biqsgd", "artemis"]
    cfgs = [art.variant_config(v, D, N) for v in variants]
    gs = [fed.gamma_max(prob, c) for c in cfgs]
    res, us = _timed_sweep(prob, cfgs, gs, [0], 600, batch=8, eval_every=100)
    return {"loss": {v: float(res.losses[vi, vi, 0, -1])
                     for vi, v in enumerate(variants)},
            "first_loss": {v: float(res.losses[vi, vi, 0, 0])
                           for vi, v in enumerate(variants)},
            "gamma_max": dict(zip(variants, gs)), "us_per_round_cell": us}


def exp3_memory(device=None) -> Dict:
    """Fig 3b: non-i.i.d. logistic, full batch: with memory (artemis) the
    excess loss falls far below the memoryless biqsgd's."""
    dev = default_device(device)
    prob = fed.make_logistic_problem(3, n_workers=N, n_per=200, d=2,
                                     device=dev)
    opt = float(prob.global_loss(prob.solve_opt()))
    gamma = 1.0 / (2 * prob.smoothness())
    variants = ["biqsgd", "artemis"]
    cfgs = [art.variant_config(v, 2, N) for v in variants]
    res, us = _timed_sweep(prob, cfgs, [gamma], [0], 800, full_batch=True,
                           eval_every=100)
    return {"excess": {v: float(res.losses[vi, 0, 0, -1]) - opt
                       for vi, v in enumerate(variants)},
            "us_per_round_cell": us}


def exp4_pp(device=None) -> Dict:
    """Fig 5/6: partial participation p = 0.5: PP1 saturates, PP2 does not."""
    dev = default_device(device)
    prob = fed.make_logistic_problem(5, n_workers=N, n_per=200, d=2,
                                     device=dev)
    opt = float(prob.global_loss(prob.solve_opt()))
    gamma = 1.0 / (2 * prob.smoothness())
    modes = ["pp1", "pp2"]
    cfgs = [art.variant_config("artemis", 2, N, p=0.5, pp_mode=m)
            for m in modes]
    res, us = _timed_sweep(prob, cfgs, [gamma], [0], 800, full_batch=True,
                           eval_every=10)
    return {"excess": {m: float(np.mean(res.losses[mi, 0, 0, -5:])) - opt
                       for mi, m in enumerate(modes)},
            "us_per_round_cell": us}


def fig4_bits(device=None, gamma_mults: Sequence[float] = (1.0,),
              seeds: Sequence[int] = (0,),
              fault_config: Optional[faults.FaultConfig] = None,
              telemetry: bool = False) -> Dict:
    """Fig 4: loss against communicated bits on the clustered non-i.i.d.
    problem (N=20, n_per=300, d=40, batch 16, 600 rounds, eval every 5).
    ``gamma_mults`` scale the reference's step 0.5/L; the grid is the
    5 variants x gammas x seeds, every variant under ``fault_config``, with
    the sweep's telemetry when ``telemetry``.  Returns, per variant, the
    bits the first cell (gamma 0, seed 0) spent to halve the excess loss
    (inf if never), the grid's rollbacks, and the ``SweepResult``
    (``sweep``)."""
    dev = default_device(device)
    prob = fed.make_clustered_problem(5, n_workers=N, n_per=300, d=40,
                                      device=dev)
    opt = float(prob.global_loss(prob.solve_opt()))
    target = 0.5 * (float(prob.global_loss(torch.zeros(40, device=dev)))
                    - opt)
    gamma = 0.5 / prob.smoothness()
    variants = ["sgd", "qsgd", "diana", "biqsgd", "artemis"]
    cfgs = [dataclasses.replace(art.variant_config(v, 40, N),
                                faults=fault_config) for v in variants]
    res, us = _timed_sweep(prob, cfgs, [gamma * m for m in gamma_mults],
                           list(seeds), 600, batch=16, eval_every=5,
                           telemetry=telemetry)
    out = {}
    for vi, v in enumerate(variants):
        exc = res.losses[vi, 0, 0] - opt
        hit = np.flatnonzero(exc < target)
        out[v] = float(res.bits[vi, 0, 0, hit[0]]) if hit.size else np.inf
    return {"bits_to_half_loss": out, "us_per_round_cell": us,
            "cells": len(cfgs) * len(gamma_mults) * len(seeds),
            "finite": bool(np.isfinite(res.losses).all()),
            "rollbacks": int(res.rollbacks.sum()), "sweep": res}


def exp5_faults(device=None) -> Dict:
    """Beyond Assumption 6: artemis at p = 0.5 on i.i.d. LSR (sigma_* != 0)
    in four cells: clean, sticky Markov availability (p_stay 0.9), NaN
    gradient blowups healed by scrubbing, and wire bit flips under
    scrubbing and the divergence sentinel (20, backoff 0.8).  Returns each
    cell's final loss and rollback count."""
    dev = default_device(device)
    prob, _ = fed.make_lsr_problem(9, n_workers=N, n_per=200, d=D,
                                   noise=0.4, device=dev)
    gamma = 0.5 * fed.gamma_max(prob, art.variant_config("artemis", D, N))
    base = art.variant_config("artemis", D, N, p=0.5)
    grid = {
        "clean": None,
        "markov": faults.FaultConfig(p_stay=0.9),
        "nan_blowups_scrubbed": faults.FaultConfig(blowup_rate=0.2,
                                                   scrub=True),
        "bitflips_sentinel": faults.FaultConfig(
            bitflip_rate=0.005, scrub=True, sentinel=20.0, backoff=0.8),
    }
    cfgs = [dataclasses.replace(base, faults=fc) for fc in grid.values()]
    res, us = _timed_sweep(prob, cfgs, [gamma], [0], 1500, batch=1,
                           eval_every=10)
    return {"final_loss": {name: float(res.losses[i, 0, 0, -1])
                           for i, name in enumerate(grid)},
            "rollbacks": {name: int(res.rollbacks[i, 0, 0])
                          for i, name in enumerate(grid)},
            "finite": bool(np.isfinite(res.losses[:, 0, 0, -1]).all()),
            "us_per_round_cell": us}


def fault_matrix(device=None) -> Dict:
    """The fault model's recovery checks (``benchmarks/fault_bench.py::
    run_matrix``), artemis at p = 0.7 on LSR, N = 8, d = 16, 40 rounds:
    the zero-fault config is the identity bit for bit; NaN blowups under
    scrubbing stay finite and converge; huge finite blowups under the
    sentinel roll back and back off the step size; bit flips on the
    ``cuda`` backend's fused wire under scrubbing and the sentinel stay
    finite.  Returns each check's outcome and its numbers."""
    dev = default_device(device)
    n, d = 8, 16
    prob, _ = fed.make_lsr_problem(3, n_workers=n, n_per=50, d=d, noise=0.3,
                                   device=dev)

    def run(fc, backend="dense"):
        cfg = dataclasses.replace(art.variant_config("artemis", d, n, p=0.7),
                                  faults=fc)
        return sw.run_sweep(prob, [cfg], [0.02], [0], 40, batch=4,
                            backend=backend, device=dev)

    base, zero = run(None), run(faults.FaultConfig())
    scrub = run(faults.FaultConfig(blowup_rate=0.25, scrub=True))
    sent = run(faults.FaultConfig(blowup_rate=0.1, blowup_value=1e15,
                                  scrub=True, sentinel=1e3))
    flip = run(faults.FaultConfig(bitflip_rate=0.05, scrub=True,
                                  sentinel=1e4), backend="cuda")
    first, last = scrub.losses[0, 0, 0, 0], scrub.losses[0, 0, 0, -1]
    rb, gs = int(sent.rollbacks[0, 0, 0]), float(sent.gamma_scale[0, 0, 0])
    return {
        "identity": bool(np.array_equal(base.losses, zero.losses)
                         and np.array_equal(base.bits, zero.bits)),
        "scrub": bool(np.isfinite(scrub.losses).all() and last < first),
        "sentinel": bool(np.isfinite(sent.losses).all() and rb >= 1
                         and gs < 1.0),
        "bitflip": bool(np.isfinite(flip.losses).all()),
        "scrub_loss": [float(first), float(last)], "rollbacks": rb,
        "gamma_scale": gs,
        "bitflip_loss": [float(flip.losses[0, 0, 0, 0]),
                         float(flip.losses[0, 0, 0, -1])]}


def table3_gamma_max(device=None) -> Dict:
    """Table 3: the theory's gamma_max is sufficient for convergence.  On
    noiseless i.i.d. LSR, each of sgd, qsgd and artemis runs 400 rounds at
    gamma_max times 1, 2, ..., 128 (one sweep per variant over the gamma
    axis); a step size converges when its final loss is finite and below
    the loss at w0.  Returns, per variant, whether gamma_max
    converges and the empirical edge over it (the largest multiplier
    before the first failure, halved as the reference reports it)."""
    dev = default_device(device)
    prob, _ = fed.make_lsr_problem(123, n_workers=N, n_per=200, d=D,
                                   noise=0.0, device=dev)
    f0 = float(prob.global_loss(torch.zeros(D, device=dev)))
    mults = 2.0 ** np.arange(8)
    out, us_all = {}, []
    for variant in ("sgd", "qsgd", "artemis"):
        cfg = art.variant_config(variant, D, N)
        g = fed.gamma_max(prob, cfg)
        res, us = _timed_sweep(prob, [cfg], g * mults, [0], 400, batch=8,
                               eval_every=100)
        last = res.losses[0, :, 0, -1]
        ok = np.isfinite(last) & (last < f0)
        edge = mults[np.argmin(ok)] / 2 if (~ok).any() else mults[-1]
        out[variant] = {"gamma_max": g, "converges": bool(ok[0]),
                        "empirical_over_theory": float(edge)}
        us_all.append(us)
    return {"variants": out, "us_per_round_cell": float(np.mean(us_all))}


def thm3_variance_lower_bound(device=None) -> Dict:
    """Thm 3: the asymptotic variance grows with omega_up and omega_dwn:
    sparsification up and down at q in {1, 0.5, 0.25} (omega = 1/q - 1) on
    noisy i.i.d. LSR at gamma = 1/(6L), 800 rounds, saturates higher as q
    falls.
    Returns each q's saturation (mean excess loss over the last 10 eval
    points)."""
    dev = default_device(device)
    prob, _ = fed.make_lsr_problem(123, n_workers=N, n_per=200, d=D,
                                   noise=0.4, device=dev)
    opt = float(prob.global_loss(prob.solve_opt()))
    gamma = 1.0 / (6 * prob.smoothness())
    qs = [1.0, 0.5, 0.25]
    cfgs = [art.ArtemisConfig(dim=D, n_workers=N, up="sparsify",
                              dwn="sparsify", up_kwargs={"q": q},
                              dwn_kwargs={"q": q},
                              alpha=0.0 if q == 1.0 else None)
            for q in qs]
    res, us = _timed_sweep(prob, cfgs, [gamma], [0], 800, batch=1,
                           eval_every=10)
    sat = {q: float(np.mean(res.losses[qi, 0, 0, -10:])) - opt
           for qi, q in enumerate(qs)}
    return {"saturation": sat, "monotone": sat[0.25] > sat[1.0],
            "us_per_round_cell": us}


def toy_mesh_train(variant: str = "artemis", reduce_impl: str = "pipelined",
                   n_layers: int = 12, d: int = 64, steps: int = 20,
                   device=None, *, n_workers: int = 8,
                   p_participation: float = 1.0,
                   local_steps: int = 1, wire: str = "bucketed",
                   faults: Optional[faults.FaultConfig] = None,
                   telemetry: bool = False) -> Dict:
    """Train ToyMLP(n_layers, d) on W = ``n_workers`` simulated workers
    through the mesh wire (``wire``: bucketed or leaf), as
    ``benchmarks/bucket_ring_bench.py::bench_wire`` configures it (s=3,
    4096-byte buckets, at most 16, rows of 64, sgd(0.05), 4 W rows per
    batch), from parameters and a batch drawn with seed 0.  With
    ``local_steps`` k > 1, every k-th step communicates and the others only
    accumulate.  ``faults`` and ``telemetry`` go to the ``DistConfig``.

    Returns the loss of every step, the median µs per step (host clock
    around each step, ending in a synchronize on CUDA), the number of
    communicating steps, the launches of the mesh kernels over the run,
    the layout, the final parameters, and with telemetry the obs dict of
    every communicating step (``obs``, tensors on the device)."""
    dev = default_device(device)
    model = ToyMLP(n_layers, d).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=4 * n_workers)
    dcfg = dist.DistConfig(variant=variant, s=3,
                           p_participation=p_participation,
                           local_steps=local_steps, bucket_bytes=4096,
                           max_buckets=16, bucket_row=64,
                           reduce_impl=reduce_impl, wire=wire,
                           faults=faults, telemetry=telemetry)
    init_state, step_fn = dist.make_train_step(model, sgd(0.05), dcfg,
                                               n_workers, device=dev)
    local_fn = (dist.make_local_step(model, dcfg, n_workers)
                if local_steps > 1 else None)
    state = init_state(params)
    a0, r0 = bucket_acc.launches, bucket_ring_sum.launches
    losses, times, comm, obs = [], [], 0, []
    for i in range(steps):
        t0 = time.perf_counter()
        if local_fn is not None and (i + 1) % local_steps:
            state, (loss, _) = local_fn(state, batch)
        else:
            state, (loss, metrics) = step_fn(state, batch)
            comm += 1
            if telemetry:
                obs.append(metrics["obs"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    return {"losses": torch.stack(losses).tolist(),
            "us_per_step": float(np.median(times)) * 1e6,
            "comm_steps": comm,
            "launches": {"bucket_acc": bucket_acc.launches - a0,
                         "bucket_ring_sum": bucket_ring_sum.launches - r0},
            "layout": dcfg.layout(list(params.values())).shape,
            "params": state.params, "obs": obs}


def compressed_sgd_step(model, params: Dict[str, torch.Tensor], batch, lr,
                        *, s: int = 1, generator=None, uniforms=None):
    """One step of SGD with a compressed gradient, through the ops API's
    fused apply: the gradient of ``model.loss`` at ``params``, then for
    every leaf, in flatten order, ``c, shape = ops.encode(g)`` and
    ``w = ops.apply_update(w, c, lr, shape)``.  The uniforms come from
    ``generator``, leaf by leaf, or from ``uniforms``, a list of per-leaf
    tensors over the packed shapes.  Returns the new params and the loss at
    ``params``."""
    grads, (loss, _) = torch.func.grad_and_value(model.loss, has_aux=True)(
        params, batch)
    names = sorted(params)               # the flatten order of a flat dict
    u = [None] * len(names) if uniforms is None else uniforms
    out = {}
    for name, ui in zip(names, u):
        c, shape = ops.encode(grads[name], ui, generator, s=s)
        out[name] = ops.apply_update(params[name], c, lr, shape)
    return out, loss


# ---------------------------------------------------------------------------
# the language-model examples
# ---------------------------------------------------------------------------

def quickstart(steps: int = 50, device=None) -> Dict:
    """``examples/quickstart.py``: reduced starcoder2 with Artemis (s = 4,
    telemetry on) over one simulated worker, adam(3e-3), on the synthetic
    corpus at batch 8, seq 128.  Returns the losses and each step's wire
    bytes."""
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStream, TokenStreamConfig
    from repro_torch.models.model import build_model
    from repro_torch.obs import span
    from repro_torch.optim import adam
    dev = default_device(device)
    cfg = configs.get_config("starcoder2-7b", reduced=True)
    model = build_model(cfg)
    # Artemis over one worker: the uplink int8 ring and memory, the
    # zero-byte downlink broadcast; telemetry adds the obs dict
    dcfg = dist.DistConfig(variant="artemis", s=4, telemetry=True)
    init_state, step_fn = dist.make_train_step(model, adam(3e-3), dcfg, 1,
                                               device=dev)
    state = init_state(model.init(torch.Generator(device=dev).manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=128,
                                           batch=8), device=dev)
    losses, wire = [], []
    for i in range(steps):
        with span("quickstart/step"):
            state, (loss, m) = step_fn(state, stream.batch_at(i))
        losses.append(loss)
        wire.append(float(m["obs"]["wire_bytes"]))
    return {"losses": torch.stack(losses).tolist(), "wire_bytes": wire}


def lm_config(full_100m: bool = False):
    """``examples/train_lm.py``'s model: ``lm-20m`` (6 x 384, vocab 4096) or
    ``lm-100m`` (12 x 768, 12 heads, kv 4, d_ff 3072, vocab 8192)."""
    from repro_torch.models.config import ModelConfig
    if full_100m:
        return ModelConfig(name="lm-100m", family="dense", n_layers=12,
                           d_model=768, n_heads=12, n_kv=4, d_ff=3072,
                           vocab=8192, activation="silu", q_chunk=256,
                           xent_chunk=256, remat=False)
    return ModelConfig(name="lm-20m", family="dense", n_layers=6,
                       d_model=384, n_heads=6, n_kv=2, d_ff=1536,
                       vocab=4096, activation="silu", q_chunk=128,
                       xent_chunk=128, remat=False)


def train_lm(steps: int = 300, full_100m: bool = False,
             ckpt_dir: Optional[str] = None, device=None) -> Dict:
    """``examples/train_lm.py`` through ``launch.train``: artemis over one
    worker (the example's host mesh on one device), batch 16, seq 256,
    adam(3e-3), a checkpoint every 100 steps when ``ckpt_dir`` is given.
    Raises if the loss drops by no more than 0.5 nats (the example's
    check).  Returns the logs and the drop."""
    from repro_torch.launch import train as T
    cfg = lm_config(full_100m)
    argv = ["--arch", cfg.name, "--steps", str(steps), "--batch", "16",
            "--seq", "256", "--dist", "artemis", "--optimizer", "adam",
            "--lr", "3e-3", "--log-every", "20",
            "--device", str(default_device(device))]
    if ckpt_dir:
        argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", "100"]
    logs = T.main(argv, config=cfg)
    drop = logs[0]["loss"] - logs[-1]["loss"]
    if not drop > 0.5:
        raise RuntimeError(f"training did not learn: the loss dropped "
                           f"{drop:.3f} nats over {steps} steps")
    return {"logs": logs, "drop": drop}


def serve_lm(device=None):
    """``examples/serve_lm.py``: the reduced mixtral (MoE and a sliding
    window) served greedily, batch 4, prompt 16, 24 new tokens."""
    from repro_torch.launch import serve as S
    return S.main(["--arch", "mixtral-8x22b", "--reduced", "--batch", "4",
                   "--prompt-len", "16", "--gen", "24",
                   "--device", str(default_device(device))])


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(
        description="Run one of the language-model examples on the port.")
    ap.add_argument("name", choices=["quickstart", "train_lm", "serve_lm"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    steps = {} if args.steps is None else {"steps": args.steps}
    if args.name == "quickstart":
        res = quickstart(device=args.device, **steps)
        print(json.dumps({"first_loss": res["losses"][0],  # repro-lint: allow=print-in-library (CLI)
                          "last_loss": res["losses"][-1],
                          "wire_bytes": res["wire_bytes"][-1]}))
    elif args.name == "train_lm":
        res = train_lm(full_100m=args.full_100m, ckpt_dir=args.ckpt_dir,
                       device=args.device, **steps)
        print(json.dumps({"first_loss": res["logs"][0]["loss"],  # repro-lint: allow=print-in-library (CLI)
                          "last_loss": res["logs"][-1]["loss"],
                          "drop": res["drop"]}))
    else:
        serve_lm(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
