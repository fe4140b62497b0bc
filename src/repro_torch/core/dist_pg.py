"""The mesh wire over a ``torch.distributed`` process group: one worker per
process (port of the reference's real mesh, where each worker is a device
slice of a ``shard_map``).

``make_train_step(model, optimizer, dcfg, group, device)`` returns the
reference's ``(init_state, step_fn)``.  Each rank holds its own ``[1,
...]`` slice of the per-worker state (``h``, ``e``, ``acc``,
``prev_active``), as the reference's ``shard_map`` body sees it, and its
own copy of the replicated values (the parameters, ``hbar``).  The
aggregates are ``core/dist.py``'s, with this module's ``ProcessRing`` in
place of the simulated axis, so both wires, every fault and the telemetry
run here as they run there.

The ring.  A hop is one ``batch_isend_irecv``: this rank sends the payload
it holds to rank + 1 and receives rank - 1's.  Rank r sums its own payload,
then r-1's, r-2's, ..., as the reference's workers do, so rank 0's sum is
the simulated axis's (worker 0's) bit for bit, and the other ranks' copies
of the replicated values differ from it in the rounding of the order, as
the reference's per-worker copies do.  ``reduce_impl``:

  * ``"pipelined"``: hop j+1's send and receive are issued before hop j's
    payload is folded in, with ``bucket_acc`` (the B3 kernel, out of place)
    for the row-scale payload, so the fold runs while the next payload is
    on the wire;
  * ``"sequential"``: each hop is waited for, then decoded and added;
  * ``"psum"``: ``all_reduce`` of the decoded payload.

The leaf wire runs one ring per leaf, pipelined for the row-scale payload,
whatever ``reduce_impl`` says (as the reference's leaf wire).  Every step
communicates: ``local_steps > 1`` runs on the simulated axis only.  Loss and
metrics are the mean over the ranks and the telemetry's counts the sum
(one ``all_reduce`` each); ``wire_bytes`` is this rank's bytes times the
ranks, all ranks moving the same payload.

Backends.  The group's backend is the caller's.  NCCL takes CUDA tensors
and refuses two ranks on one device; gloo's send and receive move host
memory.  So with gloo and a CUDA device the ring copies each payload to
pinned host memory once, forwards the host copy from hop to hop, and
copies what it receives to the card for the fold (``stages_through_host``
decides it from the backend and the device, never from a failure); NCCL
moves device memory.  ``ProcessRing.bytes_sent`` counts the payload bytes
this rank sent.

Draws.  By default every rank draws the whole ``[W]`` step of
``MeshNoise(dcfg.seed, ...)`` on its device and keeps its own slice, so a
process-group run sees the simulated axis's draws; ``noise`` takes any
``MeshNoiseSource``.

``launch(target, world_size, ...)`` starts the ranks as processes on one
host (``tcp://localhost``), each with a 60 s collective timeout, and waits
for them within a timeout of its own.
"""
from __future__ import annotations

import datetime
import multiprocessing
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as tdist

from repro_torch import default_device
from repro_torch.core import bucketing
from repro_torch.core import codec as wire
from repro_torch.core import dist as D
from repro_torch.core.noise import MeshDraws, MeshNoise, MeshNoiseSource
from repro_torch.kernels.bucket_ring import bucket_acc

TIMEOUT = datetime.timedelta(seconds=60)


def stages_through_host(backend: str, device) -> bool:
    """True where the ring copies payloads through host memory: gloo with
    a CUDA device (gloo's send and receive take host memory)."""
    return backend == "gloo" and torch.device(device).type == "cuda"


class ProcessRing:
    """The worker axis as a process group: this rank is one local worker
    (the aggregates' ``L = 1``).  ``ring`` and ``leaf_ring`` return this
    rank's sum; ``dense`` and ``sum`` all-reduce."""

    def __init__(self, group, device, reduce_impl: str = "pipelined"):
        self.group, self.reduce_impl = group, reduce_impl
        self.device = torch.device(device)
        self.rank = tdist.get_rank(group)
        self.n = tdist.get_world_size(group)
        self.staged = stages_through_host(tdist.get_backend(group),
                                          self.device)
        self.bytes_sent = 0

    # --- moving tensors ----------------------------------------------------

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)            # waits for the card's copy

    def _from_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True) if self.staged else t

    def _exchange(self, tensors: Sequence[torch.Tensor]):
        """Start one hop: send ``tensors`` (on the wire already) to rank +
        1, receive rank - 1's into new buffers.  Returns (works,
        buffers)."""
        recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device,
                            pin_memory=self.staged) for t in tensors]
        nxt, prv = (self.rank + 1) % self.n, (self.rank - 1) % self.n
        ops = ([tdist.P2POp(tdist.isend, t, group=self.group,
                            group_peer=nxt) for t in tensors]
               + [tdist.P2POp(tdist.irecv, r, group=self.group,
                              group_peer=prv) for r in recv])
        works = tdist.batch_isend_irecv(ops)
        self.bytes_sent += sum(t.numel() * t.element_size()
                               for t in tensors)
        return works, recv

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        w = self._to_wire(x)
        tdist.all_reduce(w, group=self.group)
        return self._from_wire(w) if self.staged else w

    # --- the aggregates' interface -----------------------------------------

    def ring(self, codec: wire.Codec,
             payload: wire.WirePayload) -> torch.Tensor:
        if self.reduce_impl == "psum":
            return self._all_reduce(codec.decode(payload)[0])
        fused = codec.fused_acc and self.reduce_impl == "pipelined"
        return self._ring(codec, payload, fused)

    def leaf_ring(self, codec: wire.Codec,
                  payload: wire.WirePayload) -> torch.Tensor:
        return self._ring(codec, payload, codec.fused_acc)

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x[0])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x)

    def _ring(self, codec: wire.Codec, payload: wire.WirePayload,
              fused: bool) -> torch.Tensor:
        """This rank's sum over the ring: its own payload, then rank - 1's,
        rank - 2's, ...  ``fused``: pipelined, hop j+1 in flight while hop
        j's row-scale payload is folded with ``bucket_acc``; else each hop
        is waited for, decoded and added."""
        keys = payload.keys()
        held = [payload[k][0] for k in keys]               # on the device
        on_wire = [self._to_wire(t) for t in held]

        def decode(ts):
            return codec.decode(payload.replace(**{
                k: t[None] for k, t in zip(keys, ts)}))[0]

        def land(works, recv):
            for w in works:
                w.wait()
            return recv, [self._from_wire(t) for t in recv]

        if not fused:
            acc = decode(held)
            for _ in range(self.n - 1):
                on_wire, held = land(*self._exchange(on_wire))
                acc = acc + decode(held)
            return acc
        lv, sc = keys.index("levels"), keys.index("scales")
        shape = held[lv].shape
        c = shape[-1]
        acc = torch.zeros((held[lv].numel() // c, c), device=self.device)
        for j in range(self.n):
            pending = (self._exchange(on_wire) if j < self.n - 1
                       else None)
            acc = bucket_acc(acc, held[lv].reshape(-1, c),
                             held[sc].reshape(-1, 1))
            if pending is not None:
                on_wire, held = land(*pending)
        return acc.reshape(shape)


def rank_draws(draws: MeshDraws, rank: int) -> MeshDraws:
    """A rank's slice of a whole step's draws ``[W, ...]``; the downlink
    uniforms are every rank's."""
    def cut(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [cut(t) for t in x]
        if isinstance(x, tuple):
            return tuple(cut(t) for t in x)
        return x[rank:rank + 1]

    return MeshDraws(u_up=cut(draws.u_up), u_act=cut(draws.u_act),
                     u_dwn=draws.u_dwn, u_strag=cut(draws.u_strag),
                     u_blow=cut(draws.u_blow), flips=cut(draws.flips))


def rank_grads(model) -> Callable:
    """The default gradient of a rank: ``torch.func.grad_and_value`` of
    ``model.loss`` on this rank's batch.  Returns (grads {name: shape},
    (loss, metrics))."""
    return torch.func.grad_and_value(model.loss, has_aux=True)


def make_train_step(model, optimizer, dcfg: D.DistConfig, group=None,
                    device=None, *, noise: Optional[MeshNoiseSource] = None,
                    grad_fn: Optional[Callable] = None):
    """Build ``(init_state, step_fn)`` for this rank of ``group`` (the
    default group when None) on ``device`` (CUDA unless the caller names
    another).

    ``init_state(params)`` takes the replicated params dict (the model's
    leaf names in flatten order) and builds this rank's ``[1, ...]`` state.
    ``step_fn(state, batch) -> (state, (loss, metrics))`` is one
    communicating step on this rank's rows of the batch; loss and metrics
    are the mean over the ranks, ``metrics["obs"]`` the telemetry's totals
    when ``dcfg.telemetry``.  ``step_fn.ring`` is the ``ProcessRing``."""
    if dcfg.local_steps > 1:
        raise ValueError("the process-group ring communicates every step; "
                         "local_steps > 1 runs on the simulated axis "
                         "(core/dist.py)")
    dev = default_device(device)
    ring = ProcessRing(group, dev, dcfg.reduce_impl)
    grad_fn = rank_grads(model) if grad_fn is None else grad_fn
    source = noise
    shapes = leaves = None

    def init_state(params: D.Params) -> D.TrainState:
        plist = list(params.values())
        return D.TrainState(params=dict(params),
                            opt_state=optimizer.init(plist),
                            artemis=D.init_dist_state(dcfg, plist, 1,
                                                      device=dev),
                            step=0)

    def step_fn(state: D.TrainState, batch: Dict[str, torch.Tensor]):
        nonlocal source, shapes, leaves
        plist = list(state.params.values())
        if shapes is None:
            shapes = (dcfg.layout(plist).shape if dcfg.bucketed
                      else [tuple(p.shape) for p in plist])
            leaves = D.wire_leaves(dcfg, shapes)
        if source is None:
            source = MeshNoise(dcfg.seed, ring.n, shapes, dev)
        grads, (loss, metrics) = grad_fn(state.params, batch)
        g = [grads[k][None] for k in state.params]
        if dcfg.bucketed:
            g = bucketing.bucketize(dcfg.layout(plist), g)
        art = state.artemis
        draws = rank_draws(D._draws(source, dcfg, art.step, leaves),
                           ring.rank)
        if dcfg.bucketed:
            layout = dcfg.layout(plist)
            ghat, art, obs = D.bucketed_aggregate(dcfg, art, g, layout, ring,
                                                  draws)
            agg = bucketing.unbucketize(layout, ghat, like=plist)
        else:
            agg, art, obs = D.leaf_aggregate(dcfg, art, g, ring, draws)
        updates, opt_state = optimizer.update(agg, state.opt_state,
                                              state.step)
        params = {k: p - u.to(p.dtype)
                  for (k, p), u in zip(state.params.items(), updates)}
        names = sorted(metrics)
        mean = ring.sum(torch.stack([loss.detach()] + [
            metrics[k].detach().to(loss.dtype) for k in names])) / ring.n
        metrics = {k: mean[i + 1] for i, k in enumerate(names)}
        if obs is not None:
            counts = [k for k in obs if k != "wire_bytes"]
            tot = ring.sum(torch.stack([obs[k] for k in counts]))
            metrics["obs"] = {"wire_bytes": obs["wire_bytes"] * ring.n,
                              **{k: tot[i] for i, k in enumerate(counts)}}
        return D.TrainState(params, opt_state, art, state.step + 1), (
            mean[0], metrics)

    step_fn.ring = ring
    return init_state, step_fn


# ---------------------------------------------------------------------------
# starting the ranks on one host
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(target: Callable, rank: int, world: int, port: int,
               backend: str, args: tuple) -> None:
    tdist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        target(rank, world, *args)
    finally:
        tdist.destroy_process_group()


def launch(target: Callable, world_size: int, args: tuple = (), *,
           backend: str = "gloo", timeout: float = 120.0) -> List[int]:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` new
    processes (spawned, so ``target`` and ``args`` must pickle), each in a
    process group over ``tcp://localhost`` with the 60 s collective
    timeout.  Waits at most ``timeout`` seconds for them all, then
    terminates whatever still runs.  Returns the exit codes (None for a
    process that was terminated)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(target, r, world_size, port,
                                                 backend, tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    codes: List[Optional[int]] = []
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
        codes.append(p.exitcode)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return codes
