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
whatever ``reduce_impl`` says (as the reference's leaf wire).  Loss and
metrics are the mean over the ranks and the telemetry's counts the sum
(one ``all_reduce`` each); ``wire_bytes`` is this rank's bytes times the
ranks, all ranks moving the same payload.

``local_steps = k > 1`` (the reference's ``make_local_step``): k - 1 calls
of ``make_local_step``'s step add this rank's gradient to its accumulator
and send nothing, not even the loss (each returns this rank's own); the
communicating step folds ``(acc + g) / k`` in, as the simulated axis's
does.

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

The sharded mesh (``mesh=``, the reference's ``make_train_step`` over a
(data, model) or (pod, data, model) device mesh, ``launch/mesh.py``).  One
worker per coordinate of the worker axis (``dcfg.worker_axes``), each
worker the ranks of the other axes.  The ring runs over the worker axis's
group (``mesh[axis].get_group()``).  At rest the parameters are DTensors
at the policy's sharding (``pshard``, the worker axis included); a step
gathers them over the worker axis and runs the model inside the worker on
DTensors over the other axes, placed by ``strip_axes(param_spec,
worker_axes)`` (the reference's ``gspecs``).  Each gradient is
redistributed to that placement, then gathered whole: the wire encodes
full gradients, so its layout and every bit of the ring are the unsharded
step's, and each rank of a worker runs the same ring.  The optimizer
state is replicated, the per-worker Artemis state is this worker's ``[1,
...]`` block, and the update lands on each rank's block of the
parameters.  ``dcfg=None`` is plain data parallelism over the mesh: the
loss of the whole batch on DTensors, whose gradients DTensor itself
reduces over the data axis.

``launch(target, world_size, ...)`` starts the ranks as processes on one
host (``tcp://localhost``), each with a 60 s collective timeout, and waits
for them within a timeout of its own.
"""
from __future__ import annotations

import dataclasses
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


def mean_over_ranks(ring: ProcessRing, loss: torch.Tensor,
                    metrics: Dict[str, torch.Tensor]):
    """(loss, metrics) averaged over the ranks: one ``all_reduce``."""
    names = sorted(metrics)
    mean = ring.sum(torch.stack([loss.detach()] + [
        metrics[k].detach().to(loss.dtype) for k in names])) / ring.n
    return mean[0], {k: mean[i + 1] for i, k in enumerate(names)}


def _placed_like(u: torch.Tensor, p):
    """``u`` (whole on every rank) in the placement of the DTensor ``p``
    (this rank's block; no communication); a plain ``p``: ``u``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(p, DTensor):
        return u
    mesh = p.device_mesh
    return DTensor.from_local(u, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh,
                                                            p.placements)


def _local(x):
    """A replicated DTensor's value (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def dtensor_grads(model) -> Callable:
    """``model.loss``'s gradient on DTensors, with plain autograd:
    ``torch.func`` refuses DTensor's redistributions (autograd Functions
    without ``setup_context``), which the model's sharding hooks and the
    MoE anchors call.  Plain tensors made inside the model meet the
    DTensors as replicated ones.  Returns (grads {name: DTensor}, (loss,
    metrics)) as ``rank_grads`` does."""
    from torch.distributed.tensor.experimental import implicit_replication

    def grads(params, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with implicit_replication():
            loss, metrics = model.loss(leaves, batch)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
        g = {k: torch.zeros_like(p) if x is None else x
             for (k, p), x in zip(leaves.items(), got)}
        return g, (loss.detach(), {k: v.detach()
                                   for k, v in metrics.items()})

    return grads


def mesh_grads(model, mesh, worker_axes: Sequence[str]) -> Callable:
    """A worker's gradient on the sharded mesh (``dtensor_grads``) on the
    parameters (DTensors at rest, gathered over the worker axes) and this
    worker's batch, both as DTensors on the sub-mesh of the other axes.
    Each gradient is redistributed to its parameter's placement there
    (``gspecs``) and gathered whole.  Returns (grads {name: full tensor},
    (loss, metrics)) as ``rank_grads`` does."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import mesh as M
    waxes = tuple(worker_axes)
    fn = dtensor_grads(model)
    gshard: Dict = {}

    def gather(p, name):
        if name not in gshard:
            gshard[name] = M.NamedSharding(mesh, M.strip_axes(
                M.param_spec(mesh, name, tuple(p.shape)), waxes))
        want = gshard[name].placements
        if isinstance(p, DTensor) and tuple(p.placements) != tuple(want):
            p = p.redistribute(mesh, want)
        return D.to_inner(p, mesh, waxes)

    def grads(params, batch):
        inner = {k: gather(p, k) for k, p in params.items()}
        rows = {k: D.to_inner(v, mesh, waxes) for k, v in batch.items()}
        g, (loss, metrics) = fn(inner, rows)
        full = {}
        for k, x in g.items():
            if isinstance(x, DTensor):
                want = inner[k].placements
                if tuple(x.placements) != tuple(want):
                    x = x.redistribute(x.device_mesh, want)
                x = x.full_tensor()
            full[k] = x
        return full, (_local(loss), {k: _local(v)
                                     for k, v in metrics.items()})

    return grads


def make_local_step(model, dcfg: D.DistConfig, *,
                    grad_fn: Optional[Callable] = None, mesh=None):
    """Accumulate-only step for ``local_steps > 1`` on this rank (the
    reference's ``make_local_step``): run it k-1 times between
    ``make_train_step``'s communicating steps.  It adds this rank's
    gradient to its accumulator (in bucket space on the bucketed wire, per
    leaf on the leaf wire) and sends nothing; ``step_fn(state, batch) ->
    (state, (loss, metrics))`` returns this rank's own loss and metrics.
    ``mesh``: the sharded mesh's worker gradient (``mesh_grads``)."""
    if dcfg.local_steps < 2:
        raise ValueError("make_local_step needs local_steps > 1")
    if grad_fn is None:
        grad_fn = (rank_grads(model) if mesh is None
                   else mesh_grads(model, mesh, dcfg.worker_axes))

    def local_fn(state: D.TrainState, batch: Dict[str, torch.Tensor]):
        grads, out = grad_fn(state.params, batch)
        g = [grads[k][None] for k in state.params]
        if dcfg.bucketed:
            g = bucketing.bucketize(
                dcfg.layout(list(state.params.values())), g)
        return D.accumulate_local(dcfg, state, g), out

    return local_fn


def make_plain_mesh_step(model, optimizer, mesh, device=None):
    """The reference's ``dcfg=None`` step on a mesh: plain data
    parallelism over DTensors.  ``init_state(params)`` places the
    parameters (and the optimizer state, made from them) at the policy's
    sharding; ``step_fn(state, batch)`` takes the batch as DTensors
    (``ShardedBatches``) and returns the loss of the whole batch, DTensor
    reducing the gradients over the data axis."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import mesh as M
    value_grad = dtensor_grads(model)

    def init_state(params: D.Params) -> D.TrainState:
        pshard = M.params_shardings(mesh, params)
        placed = {k: M.distribute(v, pshard[k]) for k, v in params.items()}
        return D.TrainState(params=placed,
                            opt_state=optimizer.init(list(placed.values())),
                            artemis=D.init_dist_state(None, [], 1,
                                                      device=device),
                            step=0)

    def step_fn(state: D.TrainState, batch):
        with implicit_replication():
            grads, (loss, metrics) = value_grad(state.params, batch)
            agg = [g.redistribute(p.device_mesh, p.placements)
                   for g, p in zip(grads.values(), state.params.values())]
            updates, opt_state = optimizer.update(agg, state.opt_state,
                                                  state.step)
            params = {k: p - u.to(p.dtype)
                      for (k, p), u in zip(state.params.items(), updates)}
        art = dataclasses.replace(state.artemis, step=state.artemis.step + 1)
        return D.TrainState(params, opt_state, art, state.step + 1), (
            _local(loss), {k: _local(v) for k, v in metrics.items()})

    return init_state, step_fn


def make_train_step(model, optimizer, dcfg: Optional[D.DistConfig],
                    group=None, device=None, *,
                    noise: Optional[MeshNoiseSource] = None,
                    grad_fn: Optional[Callable] = None, mesh=None):
    """Build ``(init_state, step_fn)`` for this rank of ``group`` (the
    default group when None) on ``device`` (CUDA unless the caller names
    another).  ``mesh``: the sharded mesh (a ``DeviceMesh`` over the
    default group): the ring goes over the worker axis's group, the
    gradient is ``mesh_grads``'s, and ``init_state`` places the parameters
    at the policy's sharding; ``dcfg=None`` there is
    ``make_plain_mesh_step``.

    ``init_state(params)`` takes the replicated params dict (the model's
    leaf names in flatten order) and builds this rank's ``[1, ...]`` state.
    ``step_fn(state, batch) -> (state, (loss, metrics))`` is one
    communicating step on this rank's rows of the batch; loss and metrics
    are the mean over the ranks, ``metrics["obs"]`` the telemetry's totals
    when ``dcfg.telemetry``.  With ``local_steps > 1`` it folds in what
    ``make_local_step`` accumulated.  ``step_fn.ring`` is the
    ``ProcessRing``."""
    dev = default_device(device)
    if mesh is not None:
        if dcfg is None:
            return make_plain_mesh_step(model, optimizer, mesh, dev)
        if len(dcfg.worker_axes) != 1:
            raise ValueError("the mesh's ring runs over one worker axis")
        group = mesh[dcfg.worker_axes[0]].get_group()
        if grad_fn is None:
            grad_fn = mesh_grads(model, mesh, dcfg.worker_axes)
    ring = ProcessRing(group, dev, dcfg.reduce_impl)
    grad_fn = rank_grads(model) if grad_fn is None else grad_fn
    source = noise
    shapes = leaves = None

    def init_state(params: D.Params) -> D.TrainState:
        plist = list(params.values())
        if mesh is not None:
            from repro_torch.launch import mesh as M
            pshard = M.params_shardings(mesh, params)
            params = {k: M.distribute(v, pshard[k])
                      for k, v in params.items()}
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
        if dcfg.local_steps > 1:
            g, art = D._fold_local(dcfg, art, g)
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
        params = {k: p - _placed_like(u.to(p.dtype), p)
                  for (k, p), u in zip(state.params.items(), updates)}
        loss, metrics = mean_over_ranks(ring, loss, metrics)
        if obs is not None:
            counts = [k for k in obs if k != "wire_bytes"]
            tot = ring.sum(torch.stack([obs[k] for k in counts]))
            metrics["obs"] = {"wire_bytes": obs["wire_bytes"] * ring.n,
                              **{k: tot[i] for i, k in enumerate(counts)}}
        return D.TrainState(params, opt_state, art, state.step + 1), (
            loss, metrics)

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
           backend: str = "gloo",
           timeout: Optional[float] = 120.0) -> List[int]:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` new
    processes (spawned, so ``target`` and ``args`` must pickle), each in a
    process group over ``tcp://localhost`` with the 60 s collective
    timeout.  Waits at most ``timeout`` seconds for them all (None: until
    they end; a rank that dies fails its peers' next collective within the
    collective timeout), then terminates whatever still runs.  Returns the
    exit codes (None for a process that was terminated)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(target, r, world_size, port,
                                                 backend, tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    codes: List[Optional[int]] = []
    for p in procs:
        p.join(None if deadline is None
               else max(deadline - time.monotonic(), 0.0))
        codes.append(p.exitcode)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return codes
