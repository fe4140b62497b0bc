"""Mesh-distributed Artemis on one card: compressed gradient aggregation
over a simulated worker axis (port of the bucketed half of
``repro/core/dist.py``).

The reference runs W workers as slices of a device mesh inside a
``shard_map``.  Here the W workers are a leading ``[W]`` axis on one card:
every per-worker tensor is a ``[W, ...]`` stack, each worker's gradient
comes from ``torch.func.vmap`` over that axis, and a ring hop (the
reference's ``ppermute`` from worker j to j+1) moves the payload stack one
worker on along it: an offset in the kernel's index on the pipelined ring,
``torch.roll`` on the sequential one.

Wire layer (``wire="bucketed"``, DESIGN.md §7): the gradient is flattened
into ``<= K`` equal f32 buckets (``core/bucketing.py``), every bucket row is
squant-encoded into ``int8 levels + f32 row-scales``, and the payloads go
round the ring.  ``reduce_impl`` picks the transport:

  * ``"pipelined"`` (default): the reference's ``bucket_ring_reduce``.
    Each hop folds the payload that has reached each worker into one
    accumulator, in place, with the ``bucket_acc`` kernel
    (``bucket_acc_hop_``); W launches per step.
  * ``"sequential"``: the decode-then-add ring, in plain PyTorch.  Worker
    w adds its own payload, then w-1's, w-2's, ... in both transports, so
    the two are equal bit for bit.
  * ``"psum"``: the all-reduce.  On the simulated axis it is one
    all-at-once sum over ``[W]``: decode, then add in worker order, which
    the ``bucket_ring_sum`` kernel computes in one launch.

Replicated quantities (``hbar``, the aggregate, the parameters) exist once
here.  In the reference every worker holds its own copy, updated with its
own ring sum; the copies differ only in the rounding of the sum's order,
and a read of a replicated output shows worker 0's.  The port uses worker
0's sum.  The downlink broadcast costs zero bytes in the reference, as
every worker compresses the identical aggregate with an identical key;
here it is one compression with the shared uniforms ``u_dwn``.

Randomness enters as tensors from a noise source (``core/noise.py``), in
place of the reference's ``_round_keys`` chain.

Not ported yet (each raises ``NotImplementedError``): the leaf wire, fault
injection on the mesh (ROADMAP A7, queued with A10), mesh telemetry
(A11), and the ``shard_map`` and ``NamedSharding`` helpers, which have no
meaning on a simulated axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import default_device
from repro_torch.core import bucketing
from repro_torch.core import codec as wire
from repro_torch.core import faults as FLT
from repro_torch.core.noise import MeshDraws, MeshNoise, MeshNoiseSource
from repro_torch.kernels.bucket_ring import bucket_acc_hop_, bucket_ring_sum

VARIANTS = ("sgd", "qsgd", "diana", "biqsgd", "artemis", "dore")

WIRES = ("bucketed", "leaf")
REDUCE_IMPLS = ("pipelined", "sequential", "psum")

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    worker_axes: Tuple[str, ...] = ("pod",)   # names only: one simulated axis
    variant: str = "artemis"
    s: int = 1                      # quantization levels
    alpha: Optional[float] = None   # None -> 1/(2(omega+1)), omega = sqrt(row)/s
    p_participation: float = 1.0    # PP2 over workers when < 1
    memory_dtype: str = "float32"   # h storage dtype (bfloat16 = beyond-paper)
    error_feedback: bool = False    # Dore-style EF on the uplink
    local_steps: int = 1            # communicate every k steps (1 = every step)
    seed: int = 17
    wire: str = "bucketed"          # "bucketed" flat ring | "leaf" (not ported)
    bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES
    max_buckets: int = bucketing.DEFAULT_MAX_BUCKETS
    bucket_row: int = bucketing.DEFAULT_ROW      # per-row-scale tile C
    reduce_impl: str = "pipelined"  # "pipelined" | "sequential" | "psum"
    codec: str = "squant"           # "squant" = the native row-scale format
    codec_kwargs: Tuple[Tuple[str, Any], ...] = ()
    faults: Optional[FLT.FaultConfig] = None     # only the zero config runs
    telemetry: bool = False                      # not ported: must stay False

    def __post_init__(self):
        if self.wire not in WIRES:
            raise ValueError(f"wire={self.wire!r} not in {WIRES}")
        if self.reduce_impl not in REDUCE_IMPLS:
            raise ValueError(
                f"reduce_impl={self.reduce_impl!r} not in {REDUCE_IMPLS}")
        name = {"squant": "row_squant"}.get(self.codec, self.codec)
        known = wire.available()
        if name not in known:
            raise ValueError(f"codec={self.codec!r} not in {known}")

    @property
    def up_compress(self) -> bool:
        return self.variant in ("qsgd", "diana", "biqsgd", "artemis", "dore")

    @property
    def dwn_compress(self) -> bool:
        return self.variant in ("biqsgd", "artemis", "dore")

    @property
    def memory(self) -> bool:
        return self.variant in ("diana", "artemis", "dore")

    @property
    def use_ef(self) -> bool:
        return self.error_feedback or self.variant == "dore"

    @property
    def bucketed(self) -> bool:
        return self.wire == "bucketed"

    def layout(self, leaves) -> bucketing.BucketLayout:
        return bucketing.make_layout(leaves, bucket_bytes=self.bucket_bytes,
                                     max_buckets=self.max_buckets,
                                     row=self.bucket_row)

    def wire_codec(self, row: int) -> wire.Codec:
        """The codec on this wire for messages of length ``row``
        (``codec="squant"`` is the native per-row-scale ``row_squant``)."""
        name = {"squant": "row_squant"}.get(self.codec, self.codec)
        kw = dict(self.codec_kwargs)
        if name == "row_squant":
            kw.setdefault("s", self.s)
        return wire.make_codec(name, row, **kw)


def check_supported(cfg: DistConfig) -> None:
    """Raise for the parts of a config the port does not run yet."""
    if not cfg.bucketed:
        raise NotImplementedError(
            "wire='leaf' is not ported yet; see ROADMAP.md A10")
    FLT.check_zero(cfg.faults)
    if cfg.telemetry:
        raise NotImplementedError(
            "mesh telemetry is not ported yet; see ROADMAP.md A11")


def _not_on_a_simulated_axis(name: str) -> Callable:
    def helper(*_, **__):
        raise NotImplementedError(
            f"{name} places arrays on a device mesh, which the simulated "
            f"worker axis does not have; the torch.distributed ring is "
            f"ROADMAP.md A10")
    helper.__name__ = name
    return helper


shard_map_compat = _not_on_a_simulated_axis("shard_map_compat")
make_worker_mesh = _not_on_a_simulated_axis("make_worker_mesh")
state_specs = _not_on_a_simulated_axis("state_specs")
state_shardings = _not_on_a_simulated_axis("state_shardings")


def default_alpha_bucketed(row: int, s: int) -> float:
    """Thm 1 alpha for the bucketed wire: every row has length ``row``."""
    return float(1.0 / (2.0 * (wire.squant_omega(row, s) + 1.0)))


def _codec_alpha(cfg: DistConfig, rows) -> float:
    """Thm 1 alpha from the wire codec's omega (max over message rows)."""
    om = max(cfg.wire_codec(int(r)).omega for r in rows)
    return float(1.0 / (2.0 * (om + 1.0)))


# ---------------------------------------------------------------------------
# the ring on the simulated worker axis
# ---------------------------------------------------------------------------

def _roll(payload: wire.WirePayload) -> wire.WirePayload:
    """One hop: worker w receives worker w-1's payload."""
    return payload.replace(**{k: torch.roll(v, 1, dims=0)
                              for k, v in payload.data.items()})


def bucket_ring_reduce(codec: wire.Codec, payload: wire.WirePayload,
                       n: int) -> torch.Tensor:
    """The pipelined ring over a ``[W, B, R, C]`` payload stack: at hop j
    worker w folds in the payload of worker w - j, so it sums its own, then
    w-1's, w-2's, ...  The row-scale payload rides ``bucket_acc_hop_``:
    one accumulator, W launches in place, the hop's source worker in the
    kernel's index and no roll of the levels.  Any other codec takes the
    decode-then-add ring.  Returns every worker's sum,
    ``[W, B, R, C]``."""
    if not codec.fused_acc:
        return bucket_ring_reduce_sequential(codec, payload, n)
    q, scales = payload["levels"], payload["scales"]
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for hop in range(n):
        bucket_acc_hop_(acc, q, scales, hop)
    return acc


def bucket_ring_reduce_sequential(codec: wire.Codec,
                                  payload: wire.WirePayload,
                                  n: int) -> torch.Tensor:
    """The decode-then-add ring, in the pipelined ring's order: equal to it
    bit for bit."""
    acc = codec.decode(payload)
    held = payload
    for _ in range(n - 1):
        held = _roll(held)
        acc = acc + codec.decode(held)
    return acc


def bucket_psum(codec: wire.Codec, payload: wire.WirePayload) -> torch.Tensor:
    """The all-reduce on the simulated axis: one sum over ``[W]`` in worker
    order, ``[B, R, C]`` (the ``bucket_ring_sum`` kernel for the row-scale
    payload)."""
    if codec.fused_acc:
        return bucket_ring_sum(payload["levels"], payload["scales"])
    return codec.decode(payload).sum(0)


# ---------------------------------------------------------------------------
# Artemis aggregation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArtemisDistState:
    h: torch.Tensor            # [W, B, R, C] memories ([W] stub without)
    hbar: torch.Tensor         # [B, R, C] server memory (0-d stub without)
    e: torch.Tensor            # [W, B, R, C] EF buffers ([W] stub if off)
    acc: torch.Tensor          # [W, B, R, C] local accumulator (local steps)
    prev_active: torch.Tensor  # [W] last step's availability
    step: int                  # communicating steps done


def init_dist_state(cfg: DistConfig, params: Sequence, n_workers: int = 1,
                    *, device=None) -> ArtemisDistState:
    """Zero state for ``params`` (tensors or shapes, in flatten order)."""
    check_supported(cfg)
    dev = default_device(device)
    shape = cfg.layout(params).shape

    def full(dt):
        return torch.zeros((n_workers,) + shape, dtype=dt, device=dev)

    def stub():
        return torch.zeros((n_workers,), device=dev)

    if cfg.memory:
        mdt = getattr(torch, cfg.memory_dtype)
        h, hbar = full(mdt), torch.zeros(shape, dtype=mdt, device=dev)
    else:
        h, hbar = stub(), torch.zeros((), device=dev)
    e = full(torch.float32) if cfg.use_ef else stub()
    acc = full(torch.float32) if cfg.local_steps > 1 else stub()
    return ArtemisDistState(h=h, hbar=hbar, e=e, acc=acc,
                            prev_active=torch.zeros(n_workers, device=dev),
                            step=0)


def artemis_aggregate_bucketed(cfg: DistConfig, state: ArtemisDistState,
                               gbuckets: torch.Tensor,
                               layout: bucketing.BucketLayout,
                               n_workers: int, draws: MeshDraws):
    """Per-worker gradient buckets ``[W, B, R, C]`` -> (the descent
    direction ``[B, R, C]``, the new state), with this step's ``draws``."""
    check_supported(cfg)
    n = n_workers
    wc = cfg.wire_codec(layout.row)
    p = cfg.p_participation
    if p < 1.0:
        part = FLT.participation(FLT.of(cfg.faults), p, draws.u_act)
    else:
        part = torch.ones(n, device=gbuckets.device)
    active = part.view(n, 1, 1, 1)
    alpha = cfg.alpha if cfg.alpha is not None else (
        _codec_alpha(cfg, [layout.row]) if cfg.memory else 0.0)
    mdt = getattr(torch, cfg.memory_dtype)

    g32 = gbuckets.to(torch.float32)
    h = state.h.to(torch.float32) if cfg.memory else torch.zeros_like(g32)
    delta = (g32 - h) * active
    if cfg.use_ef:
        delta = delta + state.e

    if cfg.up_compress:
        enc = bucketing.encode_buckets(wc, delta, draws.u_up)
        # PP2: an inactive worker's payload (its EF buffer under Dore) must
        # add exactly zero to the sum
        enc = FLT.mask_payload(enc, part)
        if cfg.reduce_impl == "psum":
            dhat_sum = bucket_psum(wc, enc)
        elif cfg.reduce_impl == "sequential":
            dhat_sum = bucket_ring_reduce_sequential(wc, enc, n)[0]
        else:
            dhat_sum = bucket_ring_reduce(wc, enc, n)[0]
        dhat_i = bucketing.decode_buckets(wc, enc)
    else:
        dhat_i = delta * active
        dhat_sum = dhat_i.sum(0)

    e_new = (active * (delta - dhat_i) + (1 - active) * state.e
             if cfg.use_ef else state.e)
    if cfg.memory:
        hbar = state.hbar.to(torch.float32)
        ghat = hbar + dhat_sum / (p * n)
        h_new = (h + alpha * dhat_i).to(mdt)
        hbar_new = (hbar + alpha * dhat_sum / n).to(mdt)
    else:
        ghat = dhat_sum / (p * n)
        h_new, hbar_new = state.h, state.hbar
    if cfg.dwn_compress:
        ghat = bucketing.decode_buckets(
            wc, bucketing.encode_buckets(wc, ghat, draws.u_dwn))

    return ghat, ArtemisDistState(h_new, hbar_new, e_new, state.acc, part,
                                  state.step + 1)


def artemis_aggregate(*_, **__):
    """The leaf wire's aggregate (one ring per parameter)."""
    raise NotImplementedError(
        "wire='leaf' is not ported yet; see ROADMAP.md A10")


# ---------------------------------------------------------------------------
# train-step factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Any
    artemis: ArtemisDistState
    step: int


def _bucketed_grads(model, dcfg: DistConfig, params: Params,
                    batch: Dict[str, torch.Tensor], n_workers: int):
    """Each worker's gradient as a ``[W, B, R, C]`` bucket stack, with the
    layout and the workers' mean loss and metrics (the reference's pmean).
    The batch's rows are split into W contiguous blocks (the reference's
    ``P(worker_axes)`` batch spec); the parameters are shared."""
    split = {k: v.reshape((n_workers, -1) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    fn = torch.func.grad_and_value(model.loss, has_aux=True)
    grads, (loss, metrics) = torch.func.vmap(fn, in_dims=(None, 0))(
        params, split)
    layout = dcfg.layout(list(params.values()))
    gb = bucketing.bucketize(layout, [grads[k] for k in params])
    return layout, gb, (loss.mean(), {k: v.mean()
                                      for k, v in metrics.items()})


def make_local_step(model, dcfg: DistConfig, n_workers: int):
    """Accumulate-only step for ``local_steps > 1``: run it k-1 times
    between ``make_train_step``'s communicating steps.  It adds each
    worker's bucketed gradient to its accumulator and moves nothing over
    the wire."""
    check_supported(dcfg)
    if dcfg.local_steps < 2:
        raise ValueError("make_local_step needs local_steps > 1")

    def local_fn(state: TrainState, batch):
        _, gb, out = _bucketed_grads(model, dcfg, state.params, batch,
                                     n_workers)
        art = dataclasses.replace(state.artemis, acc=state.artemis.acc + gb)
        return dataclasses.replace(state, artemis=art), out

    return local_fn


def make_train_step(model, optimizer, dcfg: DistConfig, n_workers: int,
                    device=None, *, noise: Optional[MeshNoiseSource] = None):
    """Build ``(init_state, step_fn)`` for W = ``n_workers`` simulated
    workers on ``device`` (CUDA unless the caller names another).

    ``init_state(params)`` takes the params dict (the model's leaf names
    in flatten order).  ``step_fn(state, batch) -> (state, (loss,
    metrics))`` is one communicating step; loss and metrics are the
    workers' mean.  ``noise``: the source of each step's draws, by default
    ``MeshNoise(dcfg.seed, ...)`` on the device.
    """
    check_supported(dcfg)
    dev = default_device(device)
    k_local = dcfg.local_steps
    source = noise

    def init_state(params: Params) -> TrainState:
        plist = list(params.values())
        return TrainState(params=dict(params),
                          opt_state=optimizer.init(plist),
                          artemis=init_dist_state(dcfg, plist, n_workers,
                                                  device=dev),
                          step=0)

    def step_fn(state: TrainState, batch):
        nonlocal source
        layout, gb, out = _bucketed_grads(model, dcfg, state.params, batch,
                                          n_workers)
        if source is None:
            source = MeshNoise(dcfg.seed, n_workers, layout.shape, dev)
        art = state.artemis
        if k_local > 1:
            # fold in the gradients accumulated since the last sync
            gb = (art.acc + gb) / k_local
            art = dataclasses.replace(art, acc=torch.zeros_like(art.acc))
        ghat, art = artemis_aggregate_bucketed(dcfg, art, gb, layout,
                                               n_workers,
                                               source.step(art.step))
        plist = list(state.params.values())
        agg = bucketing.unbucketize(layout, ghat, like=plist)
        updates, opt_state = optimizer.update(agg, state.opt_state,
                                              state.step)
        params = {k: p - u.to(p.dtype)
                  for (k, p), u in zip(state.params.items(), updates)}
        return TrainState(params, opt_state, art, state.step + 1), out

    return init_state, step_fn
