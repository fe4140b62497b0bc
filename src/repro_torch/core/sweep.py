"""Grid sweep engine (port of ``repro/core/sweep.py::run_sweep``).

Runs the {variant} x {gamma} x {seed} grid.  The reference compiles the whole
grid into one program; the port loops over variants and lays the G * S cells
of a variant on a leading batch axis, so each round of a variant is one pass
of batched tensor ops and one launch of each kernel for the whole grid.  This
is the reference's ``group_by_variant`` semantics: every cell pays one
variant's arithmetic, not V variants'.

Per round and cell: minibatch (or full) gradients, the participation mask,
one ``artemis_round``, the step ``w -= gamma * omega`` and the unified bit
meter of the reference (every active worker pays its uplink message plus
the downlink catch-up of the rounds it missed since its last
participation, capped at one full model: Remark 3).  Loss and distance are
read every ``eval_every`` rounds.

The bit meter repeats the reference's float32 arithmetic as its XLA program
runs it on the CPU, so the metered bits match it exactly: the catch-up sum
goes over workers in worker order, and a round's bits, uplink plus catch-up,
are rounded once (XLA fuses that multiply-add into an FMA).

Faults (``ArtemisConfig.faults``, DESIGN.md §8), each gated on its config
as in the reference, so a zero-fault config runs the code of no config:
the Markov availability chain (the previous round's availability is part
of the carry), stragglers, gradient blowups, entry scrubbing of
non-finite gradients (the worker is masked inactive and its gradient
zeroed), wire corruption (inside ``artemis_round``), and the divergence
sentinel: at each eval point a cell whose loss or ``||w||`` exceeds the
sentinel (or is not finite) returns to its last good snapshot (w, state,
averages, availability, loss), its step size is scaled by ``backoff`` and
its rollback count grows.

Resumable sweeps: with ``checkpoint_dir`` the rounds run in segments of
``checkpoint_every``, every variant through one segment before the next,
and the carries of all variants and the eval series are saved after each
(``checkpoint/checkpointer.py``); ``resume=True`` restarts from the latest
snapshot, bit for bit, because the carry round-trips exactly and the noise
source keeps no state in the round index.

Telemetry (``telemetry=True``, DESIGN.md §11): every round's readings
(participation, straggler and blowup counts, entry and wire scrubbing,
the bit meters, the compression errors and the aggregate's norm) go into
each cell's packed carry of ``obs/telemetry.py``; each eval point reads it
out with the memory drift, the error-feedback norm and the rollbacks, as
``SweepResult.telemetry`` ``{metric: [V, G, S, E]}`` (``[..., B]`` for the
histogram).  The carry is not part of the sentinel's snapshot: a rollback
leaves the counts of the rounds it undid.  With telemetry off the carry
is never built, and the run is the same bit for bit.

Nothing in the round loop waits for the device: the eval readings stay on
the device until the end of the run (or the next snapshot).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.checkpoint import checkpointer
from repro_torch.core import artemis as art
from repro_torch.core import codec as wire
from repro_torch.core import faults
from repro_torch.core.federated import Problem
from repro_torch.core.noise import NoiseSource, TorchNoise
from repro_torch.kernels.ring_sum import worker_sum
from repro_torch.obs import spans
from repro_torch.obs import telemetry as obs_tel


@dataclasses.dataclass
class SweepResult:
    """Grid results, all leading axes [V(ariants), G(ammas), S(eeds)]."""
    losses: np.ndarray          # [V, G, S, E]  F(w) at each eval point
    bits: np.ndarray            # [V, G, S, E]  cumulative communicated bits
    dists: np.ndarray           # [V, G, S, E]  ||w - w*||; ||w|| if no w_star
    w_final: np.ndarray         # [V, G, S, d]
    w_avg: np.ndarray           # [V, G, S, d]  Polyak-Ruppert average
    w_tail_avg: np.ndarray      # [V, G, S, d]  average over the last half
    rollbacks: np.ndarray       # [V, G, S]  divergence-sentinel rollbacks
    gamma_scale: np.ndarray     # [V, G, S]  final backoff factor on gamma
    eval_iters: np.ndarray      # [E] iteration index k of each eval point
    traces: int = 0             # the port compiles nothing
    telemetry: Optional[dict] = None  # {metric: [V, G, S, E(, B)]}


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as an FMA rounds it.  Exact in
    float64 for the bit meter's operands (small counts times float32 sizes),
    so the one rounding is the float32 cast."""
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


# the part of a cell's carry that the sentinel rolls back (with the loss)
_SNAPSHOT = ("w", "h", "hbar", "e", "step", "wsum", "wtail", "prev_act")


class _Grid:
    """One variant over its G * S cells ([B] = gamma-major, seed-minor): its
    constants, its carry (a flat dict of tensors, ``carry["good"]`` the
    sentinel's snapshot) and its eval readings."""

    def __init__(self, problem: Problem, cfg: art.ArtemisConfig,
                 gammas: torch.Tensor, n_gammas: int, iters: int,
                 eval_every: int, full_batch: bool, w0: torch.Tensor,
                 w_star: torch.Tensor, gamma_decay: bool,
                 backend: Optional[str], telemetry: bool = False):
        self.problem, self.cfg, self.gammas = problem, cfg, gammas
        self.n_gammas, self.iters, self.eval_every = n_gammas, iters, \
            eval_every
        self.full_batch, self.w_star = full_batch, w_star
        self.gamma_decay, self.backend = gamma_decay, backend
        self.fc = fc = faults.of(cfg.faults)
        if fc.markov:
            faults.markov_rates(fc, cfg.p)   # raise on an infeasible chain
        dev = problem.device
        n, d = problem.n_workers, problem.dim
        self.cells = cells = gammas.shape[0]
        c_up, c_dwn = cfg.codecs()
        self.m1 = float(wire.FP_BITS * d)           # full-model message
        self.m2 = max(c_dwn.bits(d), 1.0)           # compressed update
        self.window = max(int(self.m1 // self.m2), 1)
        self.up_bits = float(np.float32(c_up.bits(d)))  # the ref's f32
        self.leaves = (art.uplink_leaves(cfg, backend)
                       if fc.bitflip_rate > 0.0 else ())
        w = w0.expand(cells, d).clone()
        st = art.init_state(cfg, (cells,), device=dev)
        self.carry = dict(
            w=w, h=st.h, hbar=st.hbar, e=st.e, step=st.step,
            wsum=torch.zeros_like(w), wtail=torch.zeros_like(w),
            last_part=torch.full((cells, n), -1, dtype=torch.int32,
                                 device=dev),
            bits=torch.zeros(cells, dtype=torch.float32, device=dev),
            prev_act=torch.zeros(cells, n, device=dev))
        if fc.rollback:
            good = {k: self.carry[k] for k in _SNAPSHOT}
            good["loss"] = problem.global_loss(w)
            self.carry.update(
                gscale=torch.ones(cells, device=dev),
                rb=torch.zeros(cells, dtype=torch.int32, device=dev),
                good=good)
        self.losses, self.bit_series, self.dists = [], [], []
        # the telemetry carry and readings; no part of the carry snapshot
        self.tel = self.g_star = None
        self.tel_series = []
        if telemetry:
            self.tel = obs_tel.sweep_zeros((cells,), dev)
            # grad F_i(w*) for the memory drift, once per grid
            self.g_star = problem.full_grad(w_star)

    def _tile(self, x):
        """[S, ...] seed draws -> [G * S, ...] cells (per-cell draws, from
        a source that keys on the steps, pass as they are)."""
        if x.shape[0] == self.cells or self.n_gammas == 1:
            return x
        return x.repeat((self.n_gammas,) + (1,) * (x.dim() - 1))

    def rounds(self, noise: NoiseSource, k0: int, k1: int) -> None:
        """Run rounds k0 .. k1 - 1 of every cell."""
        problem, cfg, fc, c = self.problem, self.cfg, self.fc, self.carry
        tile, iters = self._tile, self.iters
        w, wsum, wtail = c["w"], c["wsum"], c["wtail"]
        st = art.ArtemisState(c["h"], c["hbar"], c["e"], c["step"])
        last_part, bits, prev_act = c["last_part"], c["bits"], c["prev_act"]
        for k in range(k0, k1):
            nz = (noise.round(k, steps=st.step if fc.rollback else None,
                              faults=True, leaves=self.leaves)
                  if fc.enabled else noise.round(k))
            grads = (problem.full_grad(w) if self.full_batch
                     else problem.worker_grad(w, tile(nz.idx)))
            # availability: i.i.d. or the Markov chain, from one uniform
            part = faults.participation(fc, cfg.p, tile(nz.u_act), prev_act,
                                        k)
            active = part
            tel = {}
            if fc.straggler_rate > 0.0:
                # available, but missed the round's deadline
                avail = active
                active = active * (tile(nz.u_strag) >= fc.straggler_rate
                                   ).to(active.dtype)
                tel["straggler_drops"] = avail.sum(-1) - active.sum(-1)
            if fc.blowup_rate > 0.0:
                hit = faults.blowup_mask(fc, tile(nz.u_blow))
                grads = faults.apply_blowup(fc, hit, grads)
                tel["blowup_hits"] = hit.to(torch.float32).sum(-1)
            if fc.scrub:
                # a non-finite gradient masks its worker before any
                # arithmetic, and is zeroed (0 * NaN is NaN)
                pre_scrub = active
                active = active * torch.isfinite(grads).all(-1).to(
                    active.dtype)
                grads = faults.nan_to_zero(grads)
                tel["entry_scrub_drops"] = (pre_scrub.sum(-1)
                                            - active.sum(-1))
            flips = (None if nz.flips is None
                     else [(tile(b), tile(u)) for b, u in nz.flips])
            omega, st, stats = art.artemis_round(
                cfg, st, grads, tile(nz.u_up), tile(nz.u_dwn), active,
                backend=self.backend, flips=flips)
            prev_act = part
            missed = k - last_part            # rounds since last download
            catch = torch.where(missed > self.window, self.m1,
                                missed.to(torch.float32) * self.m2)
            catch = worker_sum((active * catch)[..., None])[..., 0]
            last_part = torch.where(active > 0, k, last_part)
            g = (self.gammas / math.sqrt(k + 1.0) if self.gamma_decay
                 else self.gammas)
            if fc.rollback:
                g = g * c["gscale"]
            w = w - g[:, None] * omega
            wsum = wsum + w
            wtail = wtail + (1.0 if k >= iters // 2 else 0.0) * w
            bits = bits + _fma(active.sum(-1), self.up_bits, catch)
            if self.tel is not None:
                self.tel = obs_tel.sweep_accumulate(self.tel, obs_tel.sweep_round(
                    avail=part.sum(-1), active=active.sum(-1),
                    wire_scrubbed=stats["wire_scrubbed"],
                    uplink_bits=stats["uplink_bits"],
                    dwnlink_bits=stats["dwnlink_bits"], catchup_bits=catch,
                    err_up=stats["compress_err_up"],
                    err_dwn=stats["compress_err_dwn"],
                    ghat_norm=stats["ghat_norm"], **tel))
            if (k + 1) % self.eval_every:
                continue
            loss = problem.global_loss(w)
            if fc.rollback:
                cur = dict(w=w, h=st.h, hbar=st.hbar, e=st.e, step=st.step,
                           wsum=wsum, wtail=wtail, prev_act=prev_act,
                           loss=loss)
                cur = self._sentinel(cur)
                w, wsum, wtail = cur["w"], cur["wsum"], cur["wtail"]
                prev_act, loss = cur["prev_act"], cur["loss"]
                st = art.ArtemisState(cur["h"], cur["hbar"], cur["e"],
                                      cur["step"])
            self.losses.append(loss)
            self.bit_series.append(bits)
            diff = w - self.w_star
            self.dists.append(torch.sqrt((diff * diff).sum(-1)))
            if self.tel is not None:
                self._emit(st)
        c.update(w=w, h=st.h, hbar=st.hbar, e=st.e, step=st.step, wsum=wsum,
                 wtail=wtail, last_part=last_part, bits=bits,
                 prev_act=prev_act)

    def _emit(self, st: art.ArtemisState) -> None:
        """The telemetry reading of an eval point (after the sentinel's
        choice), then a fresh stride."""
        n = self.problem.n_workers
        inv = float(np.float32(1.0 / n))

        def mean_norm(x):
            return wire.l2_norm(x).sum(-1) * inv

        rb = self.carry.get("rb")
        self.tel_series.append(obs_tel.sweep_emit(
            self.tel, self.eval_every,
            mem_drift=mean_norm(st.h - self.g_star), e_norm=mean_norm(st.e),
            rollbacks=None if rb is None else rb.to(torch.float32)))
        self.tel = obs_tel.sweep_reset_stride(self.tel)

    def telemetry(self):
        """{metric: [cells, E(, B)]} of the readings so far."""
        return {k: torch.stack([r[k] for r in self.tel_series], 1)
                for k in self.tel_series[0]}

    def _sentinel(self, cur: dict) -> dict:
        """Roll every bad cell back to its good snapshot (NaN compares
        false, so a non-finite loss or norm is bad), back off its step size
        and count the rollback; the result is the new good snapshot."""
        c, thr = self.carry, float(np.float32(self.fc.sentinel))
        bad = ~((cur["loss"] <= thr) & (wire.l2_norm(cur["w"]) <= thr))
        good = {k: torch.where(bad.reshape((-1,) + (1,) * (v.dim() - 1)),
                               c["good"][k], v)
                for k, v in cur.items()}
        c["gscale"] = torch.where(
            bad, c["gscale"] * float(np.float32(self.fc.backoff)),
            c["gscale"])
        c["rb"] = c["rb"] + bad.to(torch.int32)
        c["good"] = good
        return good

    def series(self):
        """(losses, bits, dists) [cells, evals so far]."""
        return tuple(torch.stack(x, -1) if x else torch.zeros(
            self.cells, 0, device=self.gammas.device)
            for x in (self.losses, self.bit_series, self.dists))

    def load_series(self, losses, bits, dists) -> None:
        self.losses, self.bit_series, self.dists = (
            list(torch.unbind(x, -1)) for x in (losses, bits, dists))

    def finals(self):
        """(w, w_avg, w_tail_avg, rollbacks, gamma_scale) per cell."""
        c, iters = self.carry, self.iters
        rb = c.get("rb", torch.zeros(self.cells, dtype=torch.int32))
        gs = c.get("gscale", torch.ones(self.cells))
        return (c["w"], c["wsum"] / iters,
                c["wtail"] / max(iters - iters // 2, 1), rb, gs)


def _fingerprint(problem: Problem, cfgs, iters, eval_every, batch,
                 full_batch, gamma_decay, backend, gms, seeds, w0,
                 w_star) -> str:
    """A stable identity of a sweep, for resuming it."""
    h = hashlib.sha256()
    h.update(repr((tuple(repr(c) for c in cfgs), iters, eval_every, batch,
                   full_batch, gamma_decay, backend, problem.kind,
                   float(problem.reg), tuple(problem.X.shape))).encode())
    for x in (problem.X, problem.Y, gms, w0, w_star):
        h.update(x.detach().cpu().numpy().tobytes())
    h.update(np.asarray(seeds, np.int64).tobytes())
    return h.hexdigest()


def run_sweep(problem: Problem, cfgs: Sequence[art.ArtemisConfig],
              gammas, seeds: Sequence[int], iters: int, *, batch: int = 1,
              eval_every: int = 1, full_batch: bool = False,
              w0: Optional[torch.Tensor] = None,
              w_star: Optional[torch.Tensor] = None,
              gamma_decay: bool = False, backend: Optional[str] = None,
              group_by_variant: bool = False,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: Optional[int] = None,
              resume: bool = False,
              telemetry: bool = False,
              device=None, noise: Optional[NoiseSource] = None
              ) -> SweepResult:
    """Run the {cfgs} x {gammas} x {seeds} grid on ``device`` (CUDA unless
    the caller passes another; the problem must live there).

    Args:
      gammas: G step sizes.  seeds: S non-negative integer seeds.
      iters: rounds per cell; must be divisible by ``eval_every``.
      backend: None -> each cfg's own backend; 'dense' or 'cuda' to override.
      group_by_variant: the reference's choice between one program for the
        grid and one per variant; the port always runs variant by variant,
        and, as the reference, refuses it together with ``checkpoint_dir``.
      checkpoint_dir: run in segments and save every variant's carry and
        the eval series after each (bitwise the plain run).
      checkpoint_every: rounds between snapshots (default ``eval_every``);
        a multiple of ``eval_every`` dividing ``iters``.
      resume: restart from the latest snapshot in ``checkpoint_dir`` if
        there is one; a snapshot of another sweep (its fingerprint: the
        configs, sizes, problem data, step sizes, seeds, w0, w_star) is
        refused with ValueError.  The noise source is not in the
        fingerprint: a caller's own source must give the same draws for a
        round whenever it is asked (keep no state in the round index).
      noise: the per-round noise source (``core/noise.py``); default
        ``TorchNoise`` over ``seeds`` on the device.

    Returns a SweepResult with [V, G, S, ...] arrays.
    """
    dev = default_device(device)
    if telemetry and checkpoint_dir is not None:
        raise ValueError("telemetry=True is not supported with "
                         "checkpoint_dir (the checkpoint carry holds no "
                         "metrics); run the instrumented sweep unsegmented")
    if checkpoint_dir is not None and group_by_variant:
        raise ValueError("checkpointing is not supported with "
                         "group_by_variant=True (independent sub-sweeps "
                         "would race on one checkpoint directory)")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir")
    if checkpoint_every is not None and checkpoint_dir is None:
        raise ValueError("checkpoint_every requires checkpoint_dir")
    if iters % eval_every != 0:
        raise ValueError(f"iters={iters} not divisible by "
                         f"eval_every={eval_every}")
    segment = iters
    if checkpoint_dir is not None:
        segment = eval_every if checkpoint_every is None else \
            checkpoint_every
        if segment % eval_every != 0 or iters % segment != 0:
            raise ValueError(
                f"checkpoint_every={segment} must be a multiple of "
                f"eval_every={eval_every} and divide iters={iters}")
    if problem.device != dev:
        raise ValueError(f"the problem lives on {problem.device}, the run "
                         f"on {dev}")
    n, d = problem.n_workers, problem.dim
    for cfg in cfgs:
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
    grids = [_Grid(problem, cfg, gms.repeat_interleave(S), G, iters,
                   eval_every, full_batch, w0, ws, gamma_decay, backend,
                   telemetry)
             for cfg in cfgs]
    k0 = 0
    if checkpoint_dir is not None:
        fp = _fingerprint(problem, cfgs, iters, eval_every, batch,
                          full_batch, gamma_decay, backend, gms, seeds, w0,
                          ws)
        if resume and checkpointer.latest_step(checkpoint_dir) is not None:
            k0 = _restore(checkpoint_dir, grids, fp, iters // eval_every)
    with spans.span("sweep/execute", cells=V * G * S):
        for start in range(k0, iters, segment):
            for grid in grids:        # every variant through the segment
                grid.rounds(noise, start, start + segment)
            if checkpoint_dir is not None:
                _save(checkpoint_dir, grids, fp, iters // eval_every,
                      (start + segment) // eval_every)

    def stack(parts):
        x = torch.stack(parts).cpu().numpy()
        return x.reshape((V, G, S) + x.shape[2:])

    series = [g.series() for g in grids]
    finals = [g.finals() for g in grids]
    losses, bits, dists = (stack([s[i] for s in series]) for i in range(3))
    w_fin, w_avg, w_tail, rb, gscale = (stack([f[i].to(dev) for f in finals])
                                        for i in range(5))
    tel = None
    if telemetry:
        per = [g.telemetry() for g in grids]
        tel = {k: stack([p[k] for p in per]) for k in per[0]}
    return SweepResult(
        losses=losses, bits=bits, dists=dists, w_final=w_fin, w_avg=w_avg,
        w_tail_avg=w_tail, rollbacks=rb, gamma_scale=gscale,
        eval_iters=np.arange(1, iters // eval_every + 1) * eval_every - 1,
        telemetry=tel)


def _snapshot(grids, n_evals: int):
    """The checkpoint tree: every variant's carry and its eval series,
    padded with zeros to the run's ``n_evals``."""
    series = {}
    for i, g in enumerate(grids):
        parts = {}
        for name, x in zip(("losses", "bits", "dists"), g.series()):
            full = torch.zeros(g.cells, n_evals, device=x.device)
            full[:, :x.shape[1]] = x
            parts[name] = full
        series[f"v{i}"] = parts
    return {"carry": {f"v{i}": g.carry for i, g in enumerate(grids)},
            "series": series}


def _save(ckpt_dir: str, grids, fp: str, n_evals: int, e_done: int) -> None:
    checkpointer.save(ckpt_dir, e_done, _snapshot(grids, n_evals),
                      extra={"fingerprint": fp, "e_done": e_done,
                             "n_evals": n_evals})


def _restore(ckpt_dir: str, grids, fp: str, n_evals: int) -> int:
    """Load the latest snapshot into ``grids``; returns its round."""
    extra = checkpointer.read_manifest(ckpt_dir).get("extra", {})
    if extra.get("fingerprint") != fp:
        raise ValueError(f"checkpoint in {ckpt_dir} belongs to a different "
                         f"sweep (fingerprint mismatch); refusing to resume")
    tree = checkpointer.restore(ckpt_dir, _snapshot(grids, n_evals))
    e_done = int(extra["e_done"])
    for i, g in enumerate(grids):
        g.carry = tree["carry"][f"v{i}"]
        ser = tree["series"][f"v{i}"]
        g.load_series(*(ser[k][:, :e_done]
                        for k in ("losses", "bits", "dists")))
    return e_done * grids[0].eval_every
