"""Training driver (port of ``repro/launch/train.py``).

Trains a language model of ``repro_torch.configs`` on the synthetic corpus,
with every Artemis variant over W workers simulated on one card (the
bucketed ring of ``core/dist.py``), checkpointing, loss logging through the
``obs`` event log and spans, fault injection and the host-side divergence
sentinel with lr backoff and rollbacks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
      --reduced --steps 100 --batch 8 --seq 128 --dist artemis --workers 2

It runs on CUDA unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, default_device
from repro_torch.checkpoint import checkpointer
from repro_torch.core import dist
from repro_torch.core import faults
from repro_torch.data.pipeline import Batches
from repro_torch.data.synthetic import TokenStream, TokenStreamConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.obs import events as obs_events
from repro_torch.obs import spans as obs_spans
from repro_torch.optim import adam, sgd

_EPILOG = ("The reference's --mesh (a data x model device mesh) has no "
           "counterpart on one card: W workers are simulated on the device "
           "(--workers) and the model is not sharded.")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 epilog=_EPILOG)
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


def main(argv=None, *, config: Optional[ModelConfig] = None):
    """Run the CLI on ``argv``; returns the logged records.  ``config``
    (for callers in Python) replaces the ``--arch`` lookup."""
    args = _parser().parse_args(argv)
    dev = default_device(args.device)
    cfg = config or configs.get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)

    fc = faults.FaultConfig(
        straggler_rate=args.straggler_rate, p_stay=args.p_stay,
        bitflip_rate=args.bitflip_rate, blowup_rate=args.blowup_rate,
        blowup_value=args.blowup_value, scrub=args.scrub,
        sentinel=args.sentinel, backoff=args.backoff)
    dcfg = None
    n_workers = 1
    if args.dist != "none":
        dcfg = dist.DistConfig(variant=args.dist, s=args.s,
                               p_participation=args.participation,
                               local_steps=args.local_steps,
                               faults=fc if fc.enabled else None)
        n_workers = args.workers

    def optimizer(scale):
        lr = args.lr * scale
        return adam(lr) if args.optimizer == "adam" else sgd(lr)

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    init_state, step_fn = dist.make_train_step(model, optimizer(1.0), dcfg,
                                               n_workers, device=dev)
    local_fn = (dist.make_local_step(model, dcfg, n_workers)
                if dcfg and dcfg.local_steps > 1 else None)

    stream = TokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch), device="cpu")
    batches = Batches(stream, dev)

    # console output + optional JSONL log share one schema-checked sink
    log = obs_events.EventLog(args.events, echo=True)
    log.start(config={"arch": args.arch, "dist": args.dist,
                      "steps": args.steps, "batch": args.batch,
                      "seq": args.seq, "lr": args.lr,
                      "workers": n_workers, "device": str(dev)},
              fingerprint=f"{args.arch}:{args.dist}:s{args.s}")
    try:
        state = init_state(params)
        if (args.resume and args.ckpt_dir
                and checkpointer.latest_step(args.ckpt_dir) is not None):
            state = checkpointer.restore(args.ckpt_dir, state)
            log.emit("note", text=f"restored step {state.step}")

        logs = []
        obs_spans.reset()
        t0 = time.perf_counter()
        first_s = None      # the first communicating step builds kernels
        # host-side divergence sentinel: last good state + geometric lr
        # backoff
        good_state, lr_scale, rollbacks = state, 1.0, 0
        start = state.step
        i = start
        while i < start + args.steps:
            batch = batches.batch_at(i)
            if local_fn is not None and (i + 1) % args.local_steps:
                state, (loss, metrics) = local_fn(state, batch)
            elif first_s is None:
                with obs_spans.span("train/compile+first_step"):
                    state, (loss, metrics) = step_fn(state, batch)
                    float(loss)                 # waits for the device
                first_s = time.perf_counter() - t0
            else:
                with obs_spans.span("train/step"):
                    state, (loss, metrics) = step_fn(state, batch)
            if i % args.log_every == 0 or i == start + args.steps - 1:
                loss_f = float(loss)
                bad = not np.isfinite(loss_f) or (
                    args.sentinel > 0 and loss_f > args.sentinel)
                if bad and args.sentinel > 0:
                    rollbacks += 1
                    if rollbacks > args.max_rollbacks:
                        raise RuntimeError(
                            f"loss diverged {rollbacks} times; giving up")
                    lr_scale *= args.backoff
                    state = good_state
                    _, step_fn = dist.make_train_step(
                        model, optimizer(lr_scale), dcfg, n_workers,
                        device=dev)
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
            if (args.ckpt_every and args.ckpt_dir
                    and state.step % args.ckpt_every == 0):
                checkpointer.save(args.ckpt_dir, state.step, state)
            i += 1
        if args.ckpt_dir:
            checkpointer.save(args.ckpt_dir, state.step, state)
        wall = time.perf_counter() - t0
        steady = obs_spans.total("train/step")
        if first_s is not None:
            log.emit("span", name="train/compile+first_step", dur_s=first_s)
        if steady > 0:
            log.emit("span", name="train/steady_steps", dur_s=steady)
        log.end(status="ok", wall_s=round(wall, 3))
    finally:
        log.close()
    if args.log_file:
        with open(args.log_file, "w") as f:
            json.dump(logs, f, indent=1)
    return logs


if __name__ == "__main__":
    main()
