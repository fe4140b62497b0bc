"""Artemis (paper Algorithm 1), port of ``repro/core/artemis.py``.

One round maps per-worker stochastic gradients ``grads [..., N, d]`` to the
descent direction ``omega [..., d]`` plus the next state.  Leading axes are
independent grid cells: the sweep lays its gamma x seed cells there, so every
kernel launch covers the whole grid.

    variant     C_up        C_dwn      memory(alpha)
    sgd         identity    identity   0
    qsgd        squant      identity   0
    diana       squant      identity   >0
    biqsgd      squant      squant     0
    artemis     squant      squant     >0
    sgd-mem     identity    identity   >0
    dore        squant      squant     >0, error feedback

Partial participation: ``active [..., N]`` is a {0, 1} mask.  PP1: the server
keeps per-worker memories; PP2: one server memory ``hbar``.

Randomness enters as tensors, replacing the reference's key derivation: the
uplink uniforms ``u_up [..., N, d]`` (one row per worker message) and the
downlink uniforms ``u_dwn [..., d]``.

Sums and means over the workers add in worker order (``worker_sum``, one
kernel launch on the card) and a mean multiplies by float32(1 / N), as the
reference's ``jnp.sum`` and ``jnp.mean`` do on the CPU; with the codecs'
norms (``core/codec.py``) the dense path equals the reference bit for bit
on the CPU.

``backend="cuda"`` routes codecs of the ``squant_rows`` family through the
fused kernels (``kernels/fused_memory.py`` then ``kernels/ring_sum.py``) and
the rest through the dense path, as the reference's ``"pallas"`` backend
does.

Wire faults (``cfg.faults``, ``core/faults.py``): when the config corrupts
or scrubs the uplink, the payload each worker sends is corrupted (only
active workers send), validated and scrubbed by the server, and the
worker's memory, its error feedback and the server's sum follow the
payload the server accepted.  The fused path does this on the kernel's own
output buffers: B1 writes the levels and scales, the fault operators act on
them as a ``row_squant`` payload, and B2 sums what survived.  The flip
draws enter as tensors (``flips``), one (bit, uniform) pair per payload
leaf in sorted-key order (``uplink_leaves``).  A config without wire faults
runs the code it ran before faults existed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core import codec as wire
from repro_torch.core import compression as comp
from repro_torch.core import faults
from repro_torch.kernels.fused_memory import fused_memory_update
from repro_torch.kernels.ring_sum import ring_sum, worker_sum

BACKENDS = ("dense", "cuda")


@dataclasses.dataclass(frozen=True)
class ArtemisConfig:
    dim: int
    n_workers: int
    up: str = "squant"            # uplink codec name (core/codec.py)
    dwn: str = "squant"           # downlink codec name
    up_kwargs: dict = dataclasses.field(default_factory=dict)
    dwn_kwargs: dict = dataclasses.field(default_factory=dict)
    alpha: Optional[float] = None  # None -> 1/(2(omega_up+1)); 0 disables
    p: float = 1.0                 # participation probability
    pp_mode: str = "pp2"           # 'pp1' | 'pp2'
    error_feedback: bool = False   # Dore-like error feedback
    backend: str = "dense"         # 'dense' | 'cuda' (fused uplink kernels)
    faults: Optional[faults.FaultConfig] = None  # injection + defenses

    def codecs(self) -> Tuple[wire.Codec, wire.Codec]:
        c_up = wire.make_codec(self.up, self.dim, **dict(self.up_kwargs))
        c_dwn = wire.make_codec(self.dwn, self.dim, **dict(self.dwn_kwargs))
        return c_up, c_dwn

    def compressors(self) -> Tuple[comp.Compressor, comp.Compressor]:
        c_up, c_dwn = self.codecs()
        return comp.from_codec(c_up), comp.from_codec(c_dwn)

    def resolved_alpha(self) -> float:
        if self.alpha is not None:
            return float(self.alpha)
        c_up, _ = self.codecs()
        if c_up.omega == 0.0:
            return 0.0
        return 1.0 / (2.0 * (c_up.omega + 1.0))


@dataclasses.dataclass
class ArtemisState:
    h: torch.Tensor       # [..., N, d] per-worker memories
    hbar: torch.Tensor    # [..., d] server memory
    e: torch.Tensor       # [..., N, d] error-feedback buffers
    step: torch.Tensor    # [...] int32 rounds done


def init_state(cfg: ArtemisConfig, batch: Tuple[int, ...] = (), *,
               device=None) -> ArtemisState:
    """Zero float32 state for ``batch`` cells; on CUDA unless ``device``
    says otherwise."""
    dev = default_device(device)
    n, d = cfg.n_workers, cfg.dim
    batch = tuple(batch)
    return ArtemisState(
        h=torch.zeros(batch + (n, d), device=dev),
        hbar=torch.zeros(batch + (d,), device=dev),
        e=torch.zeros(batch + (n, d), device=dev),
        step=torch.zeros(batch, dtype=torch.int32, device=dev))


def variant_config(variant: str, dim: int, n_workers: int, s: int = 1,
                   p: float = 1.0, pp_mode: str = "pp2",
                   alpha: Optional[float] = None) -> ArtemisConfig:
    """Build the config for one of the named paper variants."""
    table = {
        "sgd": dict(up="identity", dwn="identity", alpha=0.0),
        "qsgd": dict(up="squant", dwn="identity", alpha=0.0),
        "diana": dict(up="squant", dwn="identity", alpha=alpha),
        "biqsgd": dict(up="squant", dwn="squant", alpha=0.0),
        "artemis": dict(up="squant", dwn="squant", alpha=alpha),
        "sgd-mem": dict(up="identity", dwn="identity",
                        alpha=alpha if alpha is not None else 0.5),
        "dore": dict(up="squant", dwn="squant", alpha=alpha,
                     error_feedback=True),
    }
    if variant not in table:
        raise ValueError(f"unknown variant {variant!r}; "
                         f"choose from {sorted(table)}")
    return ArtemisConfig(dim=dim, n_workers=n_workers, p=p, pp_mode=pp_mode,
                         up_kwargs={"s": s}, dwn_kwargs={"s": s},
                         **table[variant])


def _uplink_dense(cfg, c_up, state, grads, u_up, active, alpha, fc, flips):
    """Reference uplink: the codec round-trip on every worker row.  Under
    wire faults the payload itself (levels, indices, scales) is corrupted
    and validated, not the decoded value."""
    delta = grads - state.h
    if cfg.error_feedback:
        delta = delta + state.e
    if not fc.wire_faults:
        delta_hat = c_up(delta, u_up)
        if cfg.error_feedback:
            new_e = state.e + (grads - state.h) - delta_hat
            new_e = active * new_e + (1 - active) * state.e
        else:
            new_e = state.e
        # only active workers send and update their memory
        delta_hat = active * delta_hat
        new_h = state.h + alpha * delta_hat
        return delta_hat, new_h, new_e, worker_sum(delta_hat), None
    payload, ok = _faulted_wire(c_up, c_up.encode(delta, u_up), active, fc,
                                flips)
    sent = c_up.decode(payload)
    sent = faults.nan_to_zero(sent) * ok if fc.scrub else sent * active
    new_e = _accepted_e(cfg, state, grads, sent, ok)
    # the fault model corrupts the encoder's output buffer, so the worker
    # memory tracks exactly what the server accepted (scrubbed: nothing)
    new_h = state.h + alpha * sent
    return sent, new_h, new_e, worker_sum(sent), _scrubbed(active, ok)


def _faulted_wire(codec, payload, active, fc, flips):
    """Corrupt what active workers sent, then let the server validate it:
    returns the payload the server keeps and ``ok [..., N, 1]``, the
    workers whose payload it accepts (a failed checksum counts as
    inactive)."""
    if fc.bitflip_rate > 0.0:
        if flips is None:
            raise ValueError("bit flips need their draws: pass flips")
        payload = faults.corrupt_payload(flips, payload, fc.bitflip_rate,
                                         only=active[..., 0])
    ok = active
    if fc.scrub:
        valid = codec.validate(payload)             # [..., N]
        ok = active * valid[..., None]
        payload = faults.scrub_payload(payload, valid)
    return payload, ok


def _accepted_e(cfg, state, grads, sent, ok):
    """The error-feedback buffers after a faulted round: updated from what
    the server accepted, unchanged for the others."""
    if not cfg.error_feedback:
        return state.e
    new_e = state.e + (grads - state.h) - sent
    return ok * new_e + (1 - ok) * state.e


def _scrubbed(active, ok):
    """Payloads the server dropped this round, per cell."""
    return active[..., 0].sum(-1) - ok[..., 0].sum(-1)


def _uplink_fused(cfg, c_up, state, grads, u_up, active, alpha, fc, flips):
    """Fused uplink for the ``squant_rows`` family: worker encode + memory
    update in one kernel over all [cells x workers] rows, then the server's
    dequant-accumulate in one kernel over all cells.  Error feedback encodes
    ``g + e - h``; its buffer update stays outside the kernels.  Under wire
    faults the kernel's levels and scales are the payload that is corrupted
    and scrubbed, and the kernel's own memory update is discarded for one
    from the accepted payload."""
    *lead, n, d = grads.shape
    m = grads.numel() // (n * d)                    # cells
    s = int(cfg.up_kwargs.get("s", 1))
    g_in = grads + state.e if cfg.error_feedback else grads
    q, scales, h_fused = fused_memory_update(
        g_in.reshape(m * n, d).contiguous(),
        state.h.reshape(m * n, d).contiguous(),
        u_up.reshape(m * n, d).contiguous(), alpha, s=s, block=(1, d))
    q = q.reshape(grads.shape)
    scales = scales.reshape(*lead, n, 1)
    if fc.wire_faults:
        return _faulted_fused(cfg, state, grads, q, scales, active, alpha,
                              fc, flips, s)
    # inactive workers neither transmit nor touch their memory
    new_h = active * h_fused.reshape(grads.shape) + (1 - active) * state.h
    if cfg.error_feedback:
        delta_full = q.to(grads.dtype) * scales     # unmasked decode
        new_e = state.e + (grads - state.h) - delta_full
        new_e = active * new_e + (1 - active) * state.e
    else:
        new_e = state.e
    act_scales = scales * active                    # [..., N, 1]
    # [M, N, ...] -> [N, M, ...] as a strided view: the kernel takes strides
    sum_hat = ring_sum(q.reshape(m, n, d).transpose(0, 1),
                       act_scales.reshape(m, n, 1).transpose(0, 1))
    delta_hat = q.to(grads.dtype) * act_scales
    return delta_hat, new_h, new_e, sum_hat.reshape(*lead, d), None


def _faulted_fused(cfg, state, grads, q, scales, active, alpha, fc, flips,
                   s):
    """The fused uplink's wire faults: B1's output buffers as a row_squant
    payload (scale = norm / s, decode q * scale), corrupted and scrubbed,
    then B2 sums ``scales * ok`` over the levels that arrived."""
    *lead, n, d = grads.shape
    m = grads.numel() // (n * d)
    meta = wire.PayloadMeta("row_squant", tuple(grads.shape),
                            str(grads.dtype), (("s", s),))
    codec = wire.make_codec("row_squant", d, s=s)
    payload, ok = _faulted_wire(
        codec, wire.WirePayload({"levels": q, "scales": scales}, meta),
        active, fc, flips)
    q, scales = payload["levels"], payload["scales"]
    act_scales = scales * ok                        # [..., N, 1]
    sum_hat = ring_sum(q.reshape(m, n, d).transpose(0, 1),
                       act_scales.reshape(m, n, 1).transpose(0, 1))
    delta_hat = q.to(grads.dtype) * act_scales
    new_e = _accepted_e(cfg, state, grads, delta_hat, ok)
    # the worker memory tracks the accepted payload (see _uplink_dense)
    new_h = state.h + alpha * delta_hat
    return (delta_hat, new_h, new_e, sum_hat.reshape(*lead, d),
            _scrubbed(active, ok))


def uplink_leaves(cfg: ArtemisConfig,
                  backend: Optional[str] = None) -> Tuple:
    """The uplink payload's leaves of one cell, in sorted-key order, as the
    noise sources take them for the wire flips: ((shape, flipped-bit
    range), ...).  The fused path's payload is B1's row_squant levels and
    scales; the dense path's is the codec's."""
    n, d = cfg.n_workers, cfg.dim
    c_up, _ = cfg.codecs()
    backend = cfg.backend if backend is None else backend
    if backend == "cuda" and c_up.fused_uplink == "squant_rows":
        c_up = wire.make_codec("row_squant", d,
                               s=int(cfg.up_kwargs.get("s", 1)))
    z = torch.zeros(n, d)
    payload = c_up.encode(z, z)
    return tuple((tuple(t.shape), faults.flip_bits(t.dtype))
                 for t in payload.leaves())


def _worker_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of x [..., N, d] over its N workers as ``jnp.mean`` computes it:
    the worker-order sum times float32(1 / N)."""
    return worker_sum(x) * float(np.float32(1.0 / x.shape[-2]))


def artemis_round(cfg: ArtemisConfig, state: ArtemisState,
                  grads: torch.Tensor, u_up: torch.Tensor,
                  u_dwn: torch.Tensor, active: Optional[torch.Tensor] = None,
                  backend: Optional[str] = None,
                  flips: Optional[Sequence] = None):
    """One communication round.

    Args:
      grads:  [..., N, d] per-worker stochastic gradients.
      u_up:   [..., N, d] uplink uniforms, one row per worker message.
      u_dwn:  [..., d] downlink uniforms.
      active: optional {0, 1} float mask [..., N]; default all active.
      backend: 'dense' or 'cuda'; default ``cfg.backend``.
      flips:  the wire flips' draws when ``cfg.faults`` flips bits: one
        (bit int32, uniform) pair per uplink payload leaf in sorted-key
        order (``uplink_leaves``), each of the leaf's size.

    Returns (omega [..., d], next ArtemisState, stats dict of [...] tensors).
    """
    c_up, c_dwn = cfg.codecs()
    alpha = cfg.resolved_alpha()
    n, d = cfg.n_workers, cfg.dim
    backend = cfg.backend if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if tuple(grads.shape[-2:]) != (n, d):
        raise ValueError(f"grads {tuple(grads.shape)} do not end in "
                         f"(N, d) = {(n, d)}")
    if active is None:
        active = torch.ones(grads.shape[:-1], dtype=grads.dtype,
                            device=grads.device)
    active = active.to(grads.dtype)[..., None]      # [..., N, 1]

    use_fused = backend == "cuda" and c_up.fused_uplink == "squant_rows"
    uplink = _uplink_fused if use_fused else _uplink_dense
    delta_hat, new_h, new_e, sum_hat, scrubbed = uplink(
        cfg, c_up, state, grads, u_up, active, alpha, faults.of(cfg.faults),
        flips)

    if cfg.pp_mode == "pp2":
        ghat = state.hbar + sum_hat / (cfg.p * n)
        new_hbar = state.hbar + alpha * sum_hat / n
    elif cfg.pp_mode == "pp1":
        # server-side copies of h_i; only ACTIVE memories are read
        ghat = (sum_hat / (cfg.p * n)
                + worker_sum(active * state.h) / (cfg.p * n))
        new_hbar = _worker_mean(new_h)
    else:
        raise ValueError(f"unknown pp_mode {cfg.pp_mode!r}")

    omega = c_dwn(ghat, u_dwn)

    delta = grads - state.h
    if cfg.error_feedback:
        delta = delta + state.e
    n_active = active[..., 0].sum(-1)
    stats = {
        "uplink_bits": n_active * c_up.bits(d),
        "dwnlink_bits": n_active * c_dwn.bits(d),
        "compress_err_up": _worker_mean(wire.sum_squares(
            delta_hat - active * delta, fused=False)[..., None])[..., 0],
        "compress_err_dwn": wire.sum_squares(omega - ghat, fused=False),
        "ghat_norm": wire.l2_norm(ghat),
        # payloads dropped by the server this round
        "wire_scrubbed": (torch.zeros_like(n_active) if scrubbed is None
                          else scrubbed),
    }
    return omega, ArtemisState(new_h, new_hbar, new_e, state.step + 1), stats
