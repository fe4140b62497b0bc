"""Grid sweep engine (port of ``repro/core/sweep.py::run_sweep``).

Runs the {variant} x {gamma} x {seed} grid.  The reference compiles the whole
grid into one program; the port loops over variants and lays the G * S cells
of a variant on a leading batch axis, so each round of a variant is one pass
of batched tensor ops and one launch of each kernel for the whole grid.  This
is the reference's ``group_by_variant`` semantics: every cell pays one
variant's arithmetic, not V variants'.

Per round and cell: minibatch (or full) gradients, the participation mask
``u_act < p``, one ``artemis_round``, the step ``w -= gamma * omega`` and the
unified bit meter of the reference (every active worker pays its uplink
message plus the downlink catch-up of the rounds it missed since its last
participation, capped at one full model: Remark 3).  Loss and distance are
read every ``eval_every`` rounds.

The bit meter repeats the reference's float32 arithmetic as its XLA program
runs it on the CPU, so the metered bits match it exactly: the catch-up sum
goes over workers in worker order, and a round's bits, uplink plus catch-up,
are rounded once (XLA fuses that multiply-add into an FMA).

Nothing in the round loop waits for the device: the eval readings stay on
the device until the end of the run.  Faults, the rollback sentinel,
telemetry and checkpoints are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core import artemis as art
from repro_torch.core.codec import FP_BITS
from repro_torch.core.federated import Problem
from repro_torch.core.noise import NoiseSource, TorchNoise
from repro_torch.kernels.ring_sum import worker_sum


@dataclasses.dataclass
class SweepResult:
    """Grid results, all leading axes [V(ariants), G(ammas), S(eeds)]."""
    losses: np.ndarray          # [V, G, S, E]  F(w) at each eval point
    bits: np.ndarray            # [V, G, S, E]  cumulative communicated bits
    dists: np.ndarray           # [V, G, S, E]  ||w - w*||; ||w|| if no w_star
    w_final: np.ndarray         # [V, G, S, d]
    w_avg: np.ndarray           # [V, G, S, d]  Polyak-Ruppert average
    w_tail_avg: np.ndarray      # [V, G, S, d]  average over the last half
    rollbacks: np.ndarray       # [V, G, S]  always 0: no sentinel yet
    gamma_scale: np.ndarray     # [V, G, S]  always 1: no backoff yet
    eval_iters: np.ndarray      # [E] iteration index k of each eval point
    traces: int = 0             # the port compiles nothing
    telemetry: Optional[dict] = None        # not ported yet: always None


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as an FMA rounds it.  Exact in
    float64 for the bit meter's operands (small counts times float32 sizes),
    so the one rounding is the float32 cast."""
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


def _run_variant(problem: Problem, cfg: art.ArtemisConfig,
                 gammas: torch.Tensor, n_gammas: int, noise: NoiseSource,
                 iters: int, eval_every: int, full_batch: bool,
                 w0: torch.Tensor, w_star: torch.Tensor, gamma_decay: bool,
                 backend: Optional[str]):
    """One variant over its G * S cells ([B] = gamma-major, seed-minor)."""
    dev = problem.device
    n, d = problem.n_workers, problem.dim
    cells = gammas.shape[0]
    c_up, c_dwn = cfg.codecs()
    m1 = float(FP_BITS * d)                   # full-model message
    m2 = max(c_dwn.bits(d), 1.0)              # compressed-update message
    window = max(int(m1 // m2), 1)
    up_bits = float(np.float32(c_up.bits(d)))  # the f32 constant of the ref

    def tile(x):                              # [S, ...] -> [G * S, ...]
        return x if n_gammas == 1 else x.repeat(
            (n_gammas,) + (1,) * (x.dim() - 1))

    w = w0.expand(cells, d).clone()
    st = art.init_state(cfg, (cells,), device=dev)
    wsum, wtail = torch.zeros_like(w), torch.zeros_like(w)
    last_part = torch.full((cells, n), -1, dtype=torch.int32, device=dev)
    bits = torch.zeros(cells, dtype=torch.float32, device=dev)
    losses, bit_series, dists = [], [], []
    for k in range(iters):
        nz = noise.round(k)
        grads = (problem.full_grad(w) if full_batch
                 else problem.worker_grad(w, tile(nz.idx)))
        active = (tile(nz.u_act) < cfg.p).to(torch.float32)
        omega, st, _ = art.artemis_round(
            cfg, st, grads, tile(nz.u_up), tile(nz.u_dwn), active,
            backend=backend)
        missed = k - last_part                # rounds since last download
        catch = torch.where(missed > window, m1,
                            missed.to(torch.float32) * m2)
        catch = worker_sum((active * catch)[..., None])[..., 0]
        last_part = torch.where(active > 0, k, last_part)
        g = gammas / math.sqrt(k + 1.0) if gamma_decay else gammas
        w = w - g[:, None] * omega
        wsum = wsum + w
        wtail = wtail + (1.0 if k >= iters // 2 else 0.0) * w
        bits = bits + _fma(active.sum(-1), up_bits, catch)
        if (k + 1) % eval_every == 0:
            losses.append(problem.global_loss(w))
            bit_series.append(bits)
            diff = w - w_star
            dists.append(torch.sqrt((diff * diff).sum(-1)))
    return (torch.stack(losses, -1), torch.stack(bit_series, -1),
            torch.stack(dists, -1), w, wsum / iters,
            wtail / max(iters - iters // 2, 1))


def run_sweep(problem: Problem, cfgs: Sequence[art.ArtemisConfig],
              gammas, seeds: Sequence[int], iters: int, *, batch: int = 1,
              eval_every: int = 1, full_batch: bool = False,
              w0: Optional[torch.Tensor] = None,
              w_star: Optional[torch.Tensor] = None,
              gamma_decay: bool = False, backend: Optional[str] = None,
              device=None, noise: Optional[NoiseSource] = None,
              telemetry: bool = False,
              checkpoint_dir: Optional[str] = None) -> SweepResult:
    """Run the {cfgs} x {gammas} x {seeds} grid on ``device`` (CUDA unless
    the caller passes another; the problem must live there).

    Args:
      gammas: G step sizes.  seeds: S non-negative integer seeds.
      iters: rounds per cell; must be divisible by ``eval_every``.
      backend: None -> each cfg's own backend; 'dense' or 'cuda' to override.
      noise: the per-round noise source (``core/noise.py``); default
        ``TorchNoise`` over ``seeds`` on the device.

    Returns a SweepResult with [V, G, S, ...] arrays.
    """
    dev = default_device(device)
    if telemetry:
        raise NotImplementedError("sweep telemetry is not ported yet; see "
                                  "ROADMAP.md")
    if checkpoint_dir is not None:
        raise NotImplementedError("resumable (checkpointed) sweeps are not "
                                  "ported yet; see ROADMAP.md")
    if iters % eval_every != 0:
        raise ValueError(f"iters={iters} not divisible by "
                         f"eval_every={eval_every}")
    if problem.device != dev:
        raise ValueError(f"the problem lives on {problem.device}, the run "
                         f"on {dev}")
    n, d = problem.n_workers, problem.dim
    for cfg in cfgs:
        art.check_supported(cfg)
        if (cfg.dim, cfg.n_workers) != (d, n):
            raise ValueError(f"cfg {cfg} does not match problem "
                             f"(d={d}, N={n})")
    gms = torch.as_tensor(np.asarray(gammas, np.float32).reshape(-1),
                          device=dev)
    V, G, S = len(cfgs), gms.shape[0], len(seeds)
    if noise is None:
        noise = TorchNoise(seeds, n, d, None if full_batch else batch,
                           problem.X.shape[1], dev)
    w0 = (torch.zeros(d, device=dev) if w0 is None
          else torch.as_tensor(w0, dtype=torch.float32, device=dev))
    ws = (torch.zeros(d, device=dev) if w_star is None
          else torch.as_tensor(w_star, dtype=torch.float32, device=dev))
    outs = [_run_variant(problem, cfg, gms.repeat_interleave(S), G, noise,
                         iters, eval_every, full_batch, w0, ws, gamma_decay,
                         backend)
            for cfg in cfgs]

    def grid(i):
        x = torch.stack([o[i] for o in outs]).cpu().numpy()
        return x.reshape((V, G, S) + x.shape[2:])

    return SweepResult(
        losses=grid(0), bits=grid(1), dists=grid(2), w_final=grid(3),
        w_avg=grid(4), w_tail_avg=grid(5),
        rollbacks=np.zeros((V, G, S), np.int32),
        gamma_scale=np.ones((V, G, S), np.float32),
        eval_iters=np.arange(1, iters // eval_every + 1) * eval_every - 1)
