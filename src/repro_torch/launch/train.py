"""Training driver (port of ``repro/launch/train.py``).

Trains a language model of ``repro_torch.configs`` on the synthetic corpus,
with every Artemis variant over W workers, checkpointing, loss logging
through the ``obs`` event log and spans, fault injection and the host-side
divergence sentinel with lr backoff and rollbacks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
      --reduced --steps 100 --batch 8 --seq 128 --dist artemis --workers 2

The W workers are simulated on one device (``--workers W``: the bucketed
ring of ``core/dist.py``), or run one process each (``--ranks W``: the
process-group ring of ``core/dist_pg.py`` over gloo, the counterpart of the
reference's worker mesh axis), or run on a sharded mesh (``--mesh DxM``:
D x M processes, the reference's (data, model) device mesh; the workers
are the D coordinates of the data axis, each with the model sharded over
its M ranks by ``launch/mesh.py``'s policy and the model's sharding hooks
set; ``--dist none`` is plain data parallelism over the mesh).  The mesh
runs over gloo on the CPU and nccl on CUDA (one card a rank).  Over ranks, each rank takes its contiguous
rows of every global batch (``data/pipeline.ShardedBatches``), the logged
loss is the mean over the ranks (so every rank takes the same rollback
decision), rank 0 writes the event log and the log file, and each rank
checkpoints into ``<ckpt-dir>/rank<r>`` (``--resume`` restores each
rank's own); on the mesh, into ``<ckpt-dir>/rank<w>`` for worker (data
coordinate) w, whole arrays written by its model rank 0, and
``--resume`` places them back on the mesh.  On CUDA rank r takes card r
mod the cards there are.  The event log's ``run_end`` counts the run's
kernel launches (over ranks, their sum) and, on CUDA, the largest peak of
device memory on a rank.

It runs on CUDA unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, default_device
from repro_torch.checkpoint import checkpointer
from repro_torch.core import dist
from repro_torch.core import dist_pg
from repro_torch.core import faults
from repro_torch.data.pipeline import ShardedBatches
from repro_torch.data.synthetic import TokenStream, TokenStreamConfig
from repro_torch.kernels import KERNELS
from repro_torch.launch import mesh as mesh_policy
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.obs import events as obs_events
from repro_torch.obs import spans as obs_spans
from repro_torch.optim import adam, sgd

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adam", choices=["sgd", "adam"])
    ap.add_argument("--dist", default="none",
                    choices=["none"] + list(dist.VARIANTS))
    ap.add_argument("--workers", type=int, default=1,
                    help="W, the workers simulated on the device (the batch "
                         "is split over them); ignored with --dist none")
    ap.add_argument("--ranks", type=int, default=0,
                    help="W workers as W processes, one worker each "
                         "(core/dist_pg.py over gloo), each on its rows of "
                         "the batch; in place of --workers")
    ap.add_argument("--mesh", default=None,
                    help="DxM: a data x model mesh of D*M processes, the "
                         "workers the D data coordinates, the model sharded "
                         "over M (launch/mesh.py)")
    ap.add_argument("--s", type=int, default=1, help="quantization levels")
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--local-steps", type=int, default=1,
                    help="communicate every k steps (grad accumulation)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restart from ckpt-dir/LATEST if present (without "
                         "this flag an existing checkpoint is ignored)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--events", default=None,
                    help="repro_torch.obs JSONL event log (omit: echo-only)")
    # --- fault injection + self-healing (core/faults.py, DESIGN.md §8) ---
    ap.add_argument("--straggler-rate", type=float, default=0.0)
    ap.add_argument("--p-stay", type=float, default=None,
                    help="Markov P(active->active); default i.i.d.")
    ap.add_argument("--bitflip-rate", type=float, default=0.0)
    ap.add_argument("--blowup-rate", type=float, default=0.0)
    ap.add_argument("--blowup-value", type=float, default=float("nan"))
    ap.add_argument("--scrub", action="store_true",
                    help="server-side finite/checksum payload scrubbing")
    ap.add_argument("--sentinel", type=float, default=0.0,
                    help="loss threshold: blown-up loss rolls back to the "
                         "last checkpoint with lr backoff (0 = off)")
    ap.add_argument("--backoff", type=float, default=0.5)
    ap.add_argument("--max-rollbacks", type=int, default=3)
    return ap


def main(argv=None, *, config: Optional[ModelConfig] = None,
         params: Optional[dict] = None, noise=None):
    """Run the CLI on ``argv``; returns the logged records (rank 0's with
    ``--ranks`` or ``--mesh``).  For callers in Python: ``config``
    replaces the ``--arch`` lookup, ``params`` (numpy arrays keyed as the
    model's) the seeded initial parameters, and ``noise`` (a
    ``MeshNoiseSource``, picklable for ranks) the wire's draws."""
    given = (config, params, noise)
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mesh is not None:
        d, m = _mesh_shape(ap, args.mesh)
        if args.ranks:
            ap.error("--mesh sets the ranks (D x M); --ranks is for the "
                     "unsharded ranks")
        if args.workers not in (1, d):
            ap.error(f"--mesh {args.mesh}: the workers are its {d} data "
                     f"coordinates; --workers is for the simulated workers")
        if args.batch % d:
            ap.error(f"--batch {args.batch} does not split over {d} data "
                     f"coordinates")
        dev = default_device(args.device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl" and d * m > torch.cuda.device_count():
            ap.error(f"--mesh {args.mesh}: nccl takes one card a rank, and "
                     f"{d * m} ranks need {d * m} cards, not "
                     f"{torch.cuda.device_count()}")
        return _launch(args, given, d * m, backend)
    if not args.ranks:
        return _train(args, given)
    if args.dist == "none":
        ap.error("--ranks needs a wire (--dist other than none)")
    if args.workers not in (1, args.ranks):
        ap.error("--ranks sets W; --workers is for the simulated workers")
    if args.batch % args.ranks:
        ap.error(f"--batch {args.batch} does not split over {args.ranks} "
                 f"ranks")
    default_device(args.device)         # raises here, not in every rank
    return _launch(args, given, args.ranks, "gloo")


def _mesh_shape(ap, text: str):
    try:
        d, m = (int(x) for x in text.split("x"))
    except ValueError:
        ap.error(f"--mesh {text!r}: expected DxM, e.g. 2x2")
    if d < 1 or m < 1:
        ap.error(f"--mesh {text!r}: both sizes must be positive")
    return d, m


def _launch(args, given, world: int, backend: str):
    """``world`` ranks of ``_train`` over ``backend``; rank 0's logs."""
    with tempfile.TemporaryDirectory() as out_dir:
        codes = dist_pg.launch(_rank_train, world, (args, given, out_dir),
                               backend=backend, timeout=None)
        outs = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    outs.append(json.load(fh))
    errors = [o["error"] for o in outs if "error" in o]
    if errors or codes != [0] * world:
        raise RuntimeError(f"a rank failed (exit codes {codes})"
                           + (f": {errors[0]}" if errors else ""))
    return outs[0]["logs"]


def _rank_train(rank: int, world: int, args, given, out_dir: str) -> None:
    """One rank of ``--ranks``: trains, then writes its logs (or its error)
    to ``out_dir/rank<r>.json``."""
    out = {}
    try:
        out["logs"] = _train(args, given, rank=rank, world=world)
    except Exception as e:  # noqa: BLE001 (handed to the parent, re-raised)
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)


def _train(args, given, rank: int = 0, world: int = 0):
    """The training loop: W = ``args.workers`` simulated workers, or (with
    ``world``) this rank of ``world`` in the default process group, one
    worker a rank (``--ranks``) or a rank of the mesh (``--mesh``)."""
    dev = default_device(args.device)
    if world and dev.type == "cuda" and args.device in (None, "cuda"):
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    config, init_params, noise = given
    cfg = config or configs.get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    mesh, worker = None, rank
    if args.mesh is not None:
        d, m = (int(x) for x in args.mesh.split("x"))
        mesh = dist.make_worker_mesh((d, m), ("data", "model"),
                                     device_type=dev.type)
        worker, model_rank = mesh.get_coordinate()

    fc = faults.FaultConfig(
        straggler_rate=args.straggler_rate, p_stay=args.p_stay,
        bitflip_rate=args.bitflip_rate, blowup_rate=args.blowup_rate,
        blowup_value=args.blowup_value, scrub=args.scrub,
        sentinel=args.sentinel, backoff=args.backoff)
    dcfg = None
    n_workers = 1
    if args.dist != "none":
        dcfg = dist.DistConfig(worker_axes=("data",) if mesh else ("pod",),
                               variant=args.dist, s=args.s,
                               p_participation=args.participation,
                               local_steps=args.local_steps,
                               faults=fc if fc.enabled else None)
        n_workers = (mesh.size(0) if mesh is not None
                     else world or args.workers)

    if mesh is not None:
        banned = dcfg.worker_axes if dcfg else ()
        model.set_sharding(mesh_policy.layer_constraint_fn(mesh, banned),
                           mesh_policy.act_constraint_fn(mesh, banned))

    def optimizer(scale):
        lr = args.lr * scale
        return adam(lr) if args.optimizer == "adam" else sgd(lr)

    def make_step(scale):
        if world:
            return dist_pg.make_train_step(model, optimizer(scale), dcfg,
                                           device=dev, noise=noise,
                                           mesh=mesh)
        return dist.make_train_step(model, optimizer(scale), dcfg,
                                    n_workers, device=dev, noise=noise)

    if init_params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    else:
        params = {k: torch.as_tensor(v).to(dev)
                  for k, v in init_params.items()}
    init_state, step_fn = make_step(1.0)
    local_fn = None
    if dcfg and dcfg.local_steps > 1:
        local_fn = (dist_pg.make_local_step(model, dcfg, mesh=mesh)
                    if world else
                    dist.make_local_step(model, dcfg, n_workers))

    stream = TokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch), device="cpu")
    if mesh is not None:
        batches = ShardedBatches(stream, dev, mesh=mesh,
                                 batch_axes=("data",))
    else:
        batches = ShardedBatches(stream, dev, rank=rank, world=world or 1)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir and world:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{worker}")
    # on the mesh every rank joins a save's gathers; a worker's model
    # rank 0 writes
    writes = mesh is None or model_rank == 0

    # console output + optional JSONL log share one schema-checked sink;
    # over ranks, rank 0's alone
    log = (obs_events.EventLog(args.events, echo=True) if rank == 0
           else obs_events.EventLog(os.devnull))
    # the bucketed wire's [B, R, C] stack, as the ring folds it
    layout = (list(dcfg.layout(list(params.values())).shape)
              if dcfg is not None and dcfg.bucketed else None)
    log.start(config={"arch": args.arch, "dist": args.dist,
                      "steps": args.steps, "batch": args.batch,
                      "seq": args.seq, "lr": args.lr,
                      "workers": n_workers, "ranks": world,
                      "mesh": args.mesh, "device": str(dev),
                      "layout": layout},
              fingerprint=f"{args.arch}:{args.dist}:s{args.s}")
    try:
        state = init_state(params)
        if (args.resume and ckpt_dir
                and checkpointer.latest_step(ckpt_dir) is not None):
            shardings = None
            if mesh is not None:
                # the parameters back at the policy's sharding on the mesh
                shardings = dist.map_tree(lambda _: None, state)
                shardings.params = mesh_policy.params_shardings(
                    mesh, state.params)
            state = checkpointer.restore(ckpt_dir, state,
                                         shardings=shardings)
            log.emit("note", text=f"restored step {state.step}")

        logs = []
        launched = [k.launches for k in KERNELS]
        obs_spans.reset()
        t0 = time.perf_counter()
        first_s = None      # the first communicating step builds kernels
        # the steady steps: from the first step's end to the device drained
        # after the loop, less the in-loop saves and the rollbacks' rebuilds
        # (each timed from the device drained); host batches and the logged
        # steps' loss reads stay in
        steady_t0, paused, steady_steps = None, 0.0, 0

        def drained():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter()

        def since(t):       # a pause of the steady clock, once it runs
            return 0.0 if steady_t0 is None else time.perf_counter() - t

        # host-side divergence sentinel: last good state + geometric lr
        # backoff
        good_state, lr_scale, rollbacks = state, 1.0, 0
        start = state.step
        i = start
        while i < start + args.steps:
            batch = batches.batch_at(i)
            local = local_fn is not None and (i + 1) % args.local_steps
            steady_steps += steady_t0 is not None
            if local:
                state, (loss, metrics) = local_fn(state, batch)
            elif first_s is None:
                with obs_spans.span("train/compile+first_step"):
                    state, (loss, metrics) = step_fn(state, batch)
                    float(loss)                 # waits for the device
                steady_t0 = time.perf_counter()
                first_s = steady_t0 - t0
            else:
                state, (loss, metrics) = step_fn(state, batch)
            if i % args.log_every == 0 or i == start + args.steps - 1:
                if local and world:
                    # a rank's local step returns its own loss (dcfg is
                    # set: local steps need a wire)
                    loss, metrics = dist_pg.mean_over_ranks(step_fn.ring,
                                                            loss, metrics)
                loss_f = float(loss)
                bad = not np.isfinite(loss_f) or (
                    args.sentinel > 0 and loss_f > args.sentinel)
                if bad and args.sentinel > 0:
                    rollbacks += 1
                    if rollbacks > args.max_rollbacks:
                        raise RuntimeError(
                            f"loss diverged {rollbacks} times; giving up")
                    lr_scale *= args.backoff
                    t = drained()
                    state = good_state
                    _, step_fn = make_step(lr_scale)
                    paused += since(t)
                    log.emit("rollback", step=state.step, count=rollbacks,
                             lr_scale=lr_scale)
                    i = state.step
                    continue
                rec = {"step": state.step, "loss": round(loss_f, 4),
                       "nll": round(float(metrics["nll"]), 4),
                       "wall_s": round(time.perf_counter() - t0, 1),
                       "rollbacks": rollbacks}
                logs.append(rec)
                log.emit("train_step", **rec)
                if not np.isfinite(loss_f):
                    raise RuntimeError("loss diverged")
                good_state = state
            if (args.ckpt_every and ckpt_dir
                    and state.step % args.ckpt_every == 0):
                t = drained()
                checkpointer.save(ckpt_dir, state.step, state, write=writes)
                paused += since(t)
            i += 1
        steady = 0.0 if steady_t0 is None else drained() - steady_t0 - paused
        if ckpt_dir:
            checkpointer.save(ckpt_dir, state.step, state, write=writes)
        wall = time.perf_counter() - t0
        if first_s is not None:
            log.emit("span", name="train/compile+first_step", dur_s=first_s)
        if steady > 0:
            log.emit("span", name="train/steady_steps", dur_s=steady,
                     steps=steady_steps)
        # the run's kernel launches (over ranks: summed over them)
        launched = [k.launches - n for k, n in zip(KERNELS, launched)]
        if world:
            total = torch.tensor(launched, device=dev)
            torch.distributed.all_reduce(total)
            launched = total.tolist()
        extra = {}
        if dev.type == "cuda":
            # the largest peak of device memory on any rank
            peak = torch.tensor([torch.cuda.max_memory_allocated(dev)],
                                device=dev)
            if world:
                torch.distributed.all_reduce(
                    peak, op=torch.distributed.ReduceOp.MAX)
            extra["device_peak_bytes"] = int(peak.item())
        log.end(status="ok", wall_s=round(wall, 3), **extra,
                kernel_launches={k.__name__: int(n)
                                 for k, n in zip(KERNELS, launched)})
    finally:
        log.close()
    if args.log_file and rank == 0:
        with open(args.log_file, "w") as f:
            json.dump(logs, f, indent=1)
    return logs


if __name__ == "__main__":
    main()
