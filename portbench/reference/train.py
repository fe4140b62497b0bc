"""The plain reference of the benchmark's training step: per-worker
gradients, the Artemis bucketed wire, and Adam, for the first steps of a
run.

The wire, as the paper's Algorithm 1 with s-quantization (s levels per
row) and the bucket layout of the port's mesh wire:

* the gradient leaves, in ``param_spec`` order, are flattened into one
  vector, zero-padded to ``B`` buckets of ``R`` rows of ``C`` elements
  (buckets of ``bucket_bytes`` of float32 rounded up to whole rows, grown
  until at most ``max_buckets`` cover the vector);
* worker w sends ``Q(g_w - h_w)``, row by row; every worker's message is
  summed; the server's direction is ``hbar + sum / (p W)``, broadcast as
  ``Q(direction)`` with one set of uniforms;
* the memories move by ``alpha`` times what was sent: ``h_w += alpha
  Q(g_w - h_w)``, ``hbar += alpha sum / W``, with ``alpha = 1 / (2 (omega
  + 1))`` and ``omega = min(C / s^2, sqrt(C) / s)``.

``Q(x)`` draws level ``floor(r) + [u < r - floor(r)]`` with ``r = s |x| /
||row||`` and sends ``sign(x) level ||row|| / s``.  The uniforms are the
port's documented noise (its ``MeshNoise``): step k draws, from one
generator on the run's device seeded with ``seed * 2**20 + k``, the uplink
uniforms ``[W, B, R, C]``, W participation uniforms, then the downlink
uniforms ``[B, R, C]``.  They are drawn here again, not taken from the
program.

``fault`` plants one of the faults the benchmark's check must catch in
this reference, put in the program's place: ``"half_batch"`` (each
worker's gradient over the first half of its rows) or ``"no_exchange"``
(each worker's sum holds only its own message).

The model's side (parameters, loss and gradient, the products' precision)
is the configuration's reference module, which the caller hands in
(``portbench.reference.for_config``); the workers, the wire and Adam are
the same for every family.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

FAULTS = ("half_batch", "no_exchange")


def layout(total: int, bucket_bytes: int, max_buckets: int, row: int):
    """(B, R, C) of the bucket stack for ``total`` elements."""
    def up(x, m):
        return -(-x // m) * m
    elems = min(up(max(bucket_bytes // 4, row), row), up(total, row))
    n = -(-total // elems)
    if n > max_buckets:
        elems = up(-(-total // max_buckets), row)
        n = -(-total // elems)
    return n, elems // row, row


def squant(x: torch.Tensor, u: torch.Tensor, s: int) -> torch.Tensor:
    """Q(x) over the last axis, decoded (float32)."""
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    r = x.abs() / safe * s
    low = torch.floor(r)
    level = low + (u < r - low).to(x.dtype)
    return torch.sign(x) * level * (norm / s)


def uniforms(seed: int, k: int, workers: int, shape, device):
    gen = torch.Generator(device=device).manual_seed(seed * 2**20 + k)
    u_up = torch.rand((workers,) + tuple(shape), generator=gen, device=device)
    torch.rand(workers, generator=gen, device=device)      # participation
    u_dwn = torch.rand(tuple(shape), generator=gen, device=device)
    return u_up, u_dwn


def aggregate(stack: torch.Tensor, h: torch.Tensor, hbar: torch.Tensor,
              u_up: torch.Tensor, u_dwn: torch.Tensor, *, s: int,
              alpha: float, p: float, fault: Optional[str] = None):
    """One step of the wire over the workers' gradients ``stack [W, B, R,
    C]`` (overwritten with what each worker sent): (the broadcast
    direction, decoded; the new ``h``; the new ``hbar``)."""
    workers = stack.shape[0]
    for w in range(workers):                # in place, a worker at a time
        stack[w] = squant(stack[w] - h[w], u_up[w], s)
    dsum = stack[0] if fault == "no_exchange" else stack.sum(0)
    ghat = hbar + dsum / (p * workers)
    return (squant(ghat, u_dwn, s), h + alpha * stack,
            hbar + alpha * dsum / workers)


def _flat(leaves: Sequence[torch.Tensor], padded: int) -> torch.Tensor:
    out = torch.zeros(padded, device=leaves[0].device)
    torch.cat([t.reshape(-1) for t in leaves], out=out[:sum(
        t.numel() for t in leaves)])
    return out


def _leaves(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    out, off = [], 0
    for shp in shapes:
        n = math.prod(shp)
        out.append(flat[off:off + n].reshape(shp))
        off += n
    return out


def _norms(ts: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.float())) for t in ts]


def train(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor],
          batches: Sequence[dict], seed: int, *, model,
          precision: str = "f32", fault: Optional[str] = None) -> dict:
    """``len(batches)`` training steps from ``weights``: the readings the
    benchmark compares (losses, the first step's gradient as Adam takes
    it, each leaf's change, the memories' norms) and the raw mean
    gradient's norms of the first step.  ``model`` is the configuration's
    reference module."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    num = model.Numerics(precision)
    opt, wire = traffic["optimizer"], traffic.get("wire")
    workers = traffic["workers"] if wire else 1
    block = traffic["reference_block"]
    names = list(weights)
    shapes = [tuple(weights[k].shape) for k in names]
    total = sum(math.prod(s) for s in shapes)
    p = {k: weights[k].detach().clone().float() for k in names}
    m = [torch.zeros_like(p[k]) for k in names]
    v = [torch.zeros_like(p[k]) for k in names]
    dev = p[names[0]].device
    if wire:
        shape = layout(total, wire["bucket_bytes"], wire["max_buckets"],
                       wire["row"])
        padded = math.prod(shape)
        s, c = wire["s"], wire["row"]
        alpha = 1.0 / (2.0 * (min(c / s**2, math.sqrt(c) / s) + 1.0))
        h = torch.zeros((workers,) + shape, device=dev)
        hbar = torch.zeros(shape, device=dev)
    out = {"losses": []}
    for k, batch in enumerate(batches):
        n = batch["tokens"].shape[0]
        per = n // workers
        take = per // 2 if fault == "half_batch" else per
        if wire:
            stack = torch.empty((workers, padded), device=dev)
            losses = []
            for w in range(workers):
                loss_w, g = model.mean_loss_grad(
                    num, cfg, p, model.rows(batch, w * per, w * per + take),
                    block)
                stack[w] = _flat(g, padded)
                losses.append(loss_w)
                del g
            loss = sum(losses) / workers
            if k == 0:
                out["raw_grad_norms"] = _norms(
                    _leaves(stack.mean(0)[:total], shapes))
            u_up, u_dwn = uniforms(seed, k, workers, shape, dev)
            ghat, h, hbar = aggregate(stack.view((workers,) + shape), h,
                                      hbar, u_up, u_dwn, s=s, alpha=alpha,
                                      p=wire["p"], fault=fault)
            del stack, u_up
            grads = _leaves(ghat.reshape(-1)[:total], shapes)
        else:
            loss, grads = model.mean_loss_grad(num, cfg, p,
                                           model.rows(batch, 0, take), block)
            if k == 0:
                out["raw_grad_norms"] = _norms(grads)
        out["losses"].append(loss)
        if k == 0:
            out["grad_norms"] = _norms(grads)
        # Adam, the bias corrections at step k + 1
        b1, b2, lr, eps = opt["b1"], opt["b2"], opt["lr"], opt["eps"]
        c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
        for i, key in enumerate(names):
            g = grads[i]
            m[i] = b1 * m[i] + (1 - b1) * g
            v[i] = b2 * v[i] + (1 - b2) * g * g
            p[key] = p[key] - lr * (m[i] / c1) / (torch.sqrt(v[i] / c2) + eps)
        del grads
    out["change_norms"] = _norms([p[k] - weights[k] for k in names])
    if wire:
        out["h_norms"] = _norms(list(h))
        out["hbar_norm"] = _norms([hbar])[0]
    return out
