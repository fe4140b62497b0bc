"""Mesh-distributed Artemis: compressed gradient aggregation over a worker
axis (port of ``repro/core/dist.py``).

The reference runs W workers as slices of a device mesh inside a
``shard_map``.  Here the W workers are a leading ``[W]`` axis on one card:
every per-worker tensor is a ``[W, ...]`` stack, each worker's gradient
comes from ``torch.func.vmap`` over that axis, and a ring hop (the
reference's ``ppermute`` from worker j to j+1) moves the payload stack one
worker on along it: an offset in the kernel's index on the pipelined ring,
``torch.roll`` on the sequential one.  ``core/dist_pg.py`` runs the same
aggregates with one worker per process of a ``torch.distributed`` group.

Two wires (``DistConfig.wire``):

  * ``"bucketed"`` (default, DESIGN.md §7): the gradient is flattened into
    ``<= K`` equal f32 buckets (``core/bucketing.py``), every bucket row is
    squant-encoded into ``int8 levels + f32 row-scales``, and the payloads
    go round the ring.  ``reduce_impl`` picks the transport:
    ``"pipelined"``, the reference's ``bucket_ring_reduce``: each hop folds
    the payload that has reached each worker into one accumulator, in
    place, with the ``bucket_acc`` kernel (``bucket_acc_hop_``), W launches
    a step; ``"sequential"``, the decode-then-add ring in plain PyTorch (the
    two add in the same order and are equal bit for bit); ``"psum"``, the
    all-reduce, one sum over ``[W]`` in worker order (the
    ``bucket_ring_sum`` kernel).
  * ``"leaf"``: the reference's ``artemis_aggregate``, one ring per
    parameter leaf in flatten order, each message a row of the leaf's last
    axis (a 0-d leaf is one message of one element).  One alpha serves
    every leaf (the largest omega).  A row-scale leaf's ring folds each hop
    with ``bucket_acc_hop_`` over the leaf's ``[W, rows, C]`` stack (W
    launches a leaf a step); any other codec decodes then adds.
    ``reduce_impl`` does not apply to the leaf wire, as in the reference.

Faults (``DistConfig.faults``, ``core/faults.py``), each gated on its
config as in the reference, so ``FaultConfig()`` runs the code of no
config: participation from the Markov chain (on availability, not on who
made the deadline), stragglers, gradient blowups, entry scrubbing (a
non-finite gradient masks its worker, per leaf on the leaf wire, and is
zeroed), bit flips on the payloads that were sent, and a checksum per
bucket (per leaf) through the codec's ``validate``: a payload that fails
it is scrubbed to zero and its worker's memory and error feedback stay
put for that bucket.  The index codecs (sparsify, topk) work on each row
of a message, where the reference's work on the whole flattened bucket or
leaf: sparsify's decoded values are the same (its payload a bit flip hits
is not), and topk keeps the largest of each row, not of the whole.

Telemetry (``DistConfig.telemetry``): both aggregates also return the
``obs`` dict of ``obs.telemetry.MESH_METRICS``, totals over the workers
(the reference's ``psum``): ``wire_bytes`` (a Python float, from the
payload's shapes: hops times the payload bytes, or the dense f32 proxy of
an all-reduce), and 0-d float32 tensors on the device for
``mesh_active``, ``mesh_scrubbed`` and ``mesh_blowup_hits``.  Nothing
waits for the device.  With telemetry off the step's metrics have no
``"obs"`` key, and its numbers are the same.

Phases (``obs/spans.py::phase``, only while a profiler runs): ``step``
around a step, with ``grads`` (the per-worker gradients) and ``optim``
(the optimizer, ``optim/apply`` its ``p - u``) under it; on the bucketed
wire ``wire/bucketize``, ``wire/noise``, ``wire/memory`` (casts, masks, the
memories and the error feedback), ``wire/encode`` (the uplink's encode,
mask, faults and checksum), ``wire/ring`` (its record carries
``wire_bytes``, the count telemetry reports, on every step), ``wire/decode``
(the worker's own payload), ``wire/downlink`` and ``wire/unbucketize``;
the leaf wire is one phase, ``wire``.

Replicated quantities (``hbar``, the aggregate, the parameters) exist once
here.  In the reference every worker holds its own copy, updated with its
own ring sum; the copies differ only in the rounding of the sum's order,
and a read of a replicated output shows worker 0's.  The port uses worker
0's sum.  The downlink broadcast costs zero bytes in the reference, as
every worker compresses the identical aggregate with an identical key;
here it is one compression with the shared uniforms ``u_dwn``.

Randomness enters as tensors from a noise source (``core/noise.py``), in
place of the reference's ``_round_keys`` chain.

The device mesh (a ``torch.distributed`` ``DeviceMesh``, one process a
rank; ``core/dist_pg.py`` runs the step on it): ``make_worker_mesh``,
``shard_map_compat`` (partial-manual ``shard_map``: each rank's block
over the worker axes as a DTensor on the other axes, ``to_inner`` and
``from_inner``), ``state_specs`` and ``state_shardings`` (the reference's
rules, as ``launch/mesh.NamedSharding``).  The simulated axis places
nothing on a mesh; ``grad_specs`` is not taken (the mesh's wire encodes
whole gradients).
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
from repro_torch.obs import spans

VARIANTS = ("sgd", "qsgd", "diana", "biqsgd", "artemis", "dore")

WIRES = ("bucketed", "leaf")
REDUCE_IMPLS = ("pipelined", "sequential", "psum")

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    worker_axes: Tuple[str, ...] = ("pod",)   # names only: one worker axis
    variant: str = "artemis"
    s: int = 1                      # quantization levels
    alpha: Optional[float] = None   # None -> 1/(2(omega+1)), omega = sqrt(row)/s
    p_participation: float = 1.0    # PP2 over workers when < 1
    memory_dtype: str = "float32"   # h storage dtype (bfloat16 = beyond-paper)
    error_feedback: bool = False    # Dore-style EF on the uplink
    local_steps: int = 1            # communicate every k steps (1 = every step)
    seed: int = 17
    wire: str = "bucketed"          # "bucketed" flat ring | "leaf" per-leaf
    bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES
    max_buckets: int = bucketing.DEFAULT_MAX_BUCKETS
    bucket_row: int = bucketing.DEFAULT_ROW      # per-row-scale tile C
    reduce_impl: str = "pipelined"  # "pipelined" | "sequential" | "psum"
    codec: str = "squant"           # "squant" = the native row-scale format
    codec_kwargs: Tuple[Tuple[str, Any], ...] = ()
    faults: Optional[FLT.FaultConfig] = None     # injection + defenses
    telemetry: bool = False         # the obs dict of MESH_METRICS

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
        fc = FLT.of(self.faults)
        if fc.markov:
            FLT.markov_rates(fc, self.p_participation)  # infeasible: raise

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


# ---------------------------------------------------------------------------
# the device mesh: one worker per coordinate of the worker axis, each rank a
# process of a torch.distributed group (launch/mesh.py has the policy)
# ---------------------------------------------------------------------------

def make_worker_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                     device_type: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over the default process group
    (tests and benchmarks that run one worker per rank), on CUDA unless
    ``device_type`` names another device type."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(default_device(device_type).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def inner_axes(mesh, manual_axes: Sequence[str]) -> Tuple[str, ...]:
    """The mesh's axes other than ``manual_axes``, in mesh order."""
    return tuple(a for a in mesh.mesh_dim_names if a not in manual_axes)


def to_inner(x, mesh, manual_axes: Sequence[str]):
    """This rank's block of the DTensor ``x`` (on ``mesh``) over the manual
    axes: a DTensor on the sub-mesh of the other axes with their placements
    (the plain local tensor when every axis is manual).  A plain tensor is
    taken as this rank's block already: on the sub-mesh it is replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    inner = inner_axes(mesh, manual_axes)
    if not isinstance(x, DTensor):
        if not inner:
            return x
        return DTensor.from_local(x, mesh[inner], [Replicate()] * len(inner),
                                  run_check=False)
    if not inner:
        return x.to_local()
    names = list(mesh.mesh_dim_names)
    # a gather along a dim other than the first leaves a strided local
    # block, which some sharded ops (einsum's views) refuse
    return DTensor.from_local(
        x.to_local().contiguous(), mesh[inner],
        [x.placements[names.index(a)] for a in inner], run_check=False)


def from_inner(y, mesh, manual_axes: Sequence[str], spec):
    """The inverse of ``to_inner``: ``y`` (a DTensor on the sub-mesh of the
    non-manual axes, or a plain tensor) as a DTensor on ``mesh``, split over
    the manual axes as ``spec`` names them (replicated over those it does
    not name: the blocks must agree)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import to_placements
    names = list(mesh.mesh_dim_names)
    manual = to_placements(mesh, spec)
    inner = inner_axes(mesh, manual_axes)
    if isinstance(y, DTensor):
        local, placed = y.to_local(), dict(zip(inner, y.placements))
    else:
        local, placed = y, {a: Replicate() for a in inner}
    return DTensor.from_local(
        local, mesh, [placed[a] if a in placed else manual[i]
                      for i, a in enumerate(names)], run_check=False)


def _is_spec(x) -> bool:
    from repro_torch.launch.mesh import Spec
    return isinstance(x, Spec)


def map_tree(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of a tree of dicts, lists, tuples and
    dataclasses (``rest``: trees of the same structure, or leaves that
    stand for a whole subtree)."""
    leaf = is_leaf or (lambda _: False)
    if leaf(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name),
                             *[_sub(r, f.name, leaf) for r in rest],
                             is_leaf=is_leaf)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *[_sub(r, k, leaf) for r in rest],
                            is_leaf=is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(map_tree(fn, v, *[_sub(r, i, leaf) for r in rest],
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _sub(tree, key, leaf):
    if leaf(tree) or _is_spec(tree):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return getattr(tree, key)
    return tree[key]


def shard_map_compat(f: Callable, mesh, in_specs, out_specs,
                     manual_axes: Sequence[str]) -> Callable:
    """Partial-manual ``shard_map`` over a ``DeviceMesh``: ``f`` runs on
    every rank with each DTensor argument cut to this rank's block over
    ``manual_axes`` (``to_inner``: a DTensor on the sub-mesh of the other
    axes, whose ops ``f`` then runs sharded; the local tensor when every
    axis is manual, as ``torch.distributed.tensor.experimental.local_map``
    hands it).  ``in_specs`` and ``out_specs`` are trees of ``Spec`` over
    the manual axes, one per argument and output (a ``Spec`` stands for a
    whole subtree); inputs are first redistributed to them on the manual
    axes.  As the reference's ``check_vma=False``: an output replicated over
    a manual axis is trusted to agree there."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import to_placements
    manual_axes = tuple(manual_axes)
    names = list(mesh.mesh_dim_names)

    def place(spec, x):
        if not isinstance(x, DTensor):
            return to_inner(x, mesh, manual_axes)
        want = to_placements(mesh, spec)
        target = [want[i] if a in manual_axes else x.placements[i]
                  for i, a in enumerate(names)]
        if tuple(target) != tuple(x.placements):
            x = x.redistribute(mesh, target)
        return to_inner(x, mesh, manual_axes)

    def unplace(spec, y):
        if not isinstance(y, torch.Tensor):
            return y
        return from_inner(y, mesh, manual_axes, spec)

    def over(fn, specs, tree):
        # a Spec leaf of ``specs`` applies to every leaf of its subtree
        return map_tree(lambda spec, sub: map_tree(
            lambda t: fn(spec, t), sub), specs, tree, is_leaf=_is_spec)

    def mapped(*args):
        return over(unplace, out_specs,
                    f(*over(place, tuple(in_specs), args)))

    return mapped


def state_specs(dcfg: Optional[DistConfig], state) -> "TrainState":
    """The worker-axis specs of a ``TrainState`` (manual axes only): the
    per-worker stacks split over the worker axes, everything else
    replicated over them."""
    from repro_torch.launch.mesh import Spec
    waxes = tuple(dcfg.worker_axes) if dcfg else ()
    rep, wsp = Spec(), Spec(waxes)
    art = state.artemis
    return TrainState(
        params=map_tree(lambda _: rep, state.params),
        opt_state=map_tree(lambda _: rep, state.opt_state),
        artemis=ArtemisDistState(
            h=map_tree(lambda _: wsp, art.h),
            hbar=map_tree(lambda _: rep, art.hbar),
            e=map_tree(lambda _: wsp, art.e),
            acc=map_tree(lambda _: wsp, art.acc),
            prev_active=wsp, step=rep),
        step=rep)


def state_shardings(mesh, state, pshard: Dict, dcfg: Optional[DistConfig]):
    """The shardings of a ``TrainState`` (``launch/mesh.NamedSharding``),
    the reference's rules: the parameters at ``pshard``; the optimizer
    state replicated.  Bucketed wire: ``h``, ``e`` and ``acc`` (``[W, B, R,
    C]`` or a ``[W]`` stub) split over the worker axes, ``hbar``
    replicated.  Leaf wire: ``h`` shifted onto the worker axes (a leading
    worker dim before the parameter's spec) where the variant has memory,
    with ``hbar`` at the parameter's sharding, else both replicated; ``e``
    and ``acc`` shifted where error feedback and local steps are on."""
    from repro_torch.launch.mesh import NamedSharding, Spec
    rep = NamedSharding(mesh, Spec())
    waxes = tuple(dcfg.worker_axes) if dcfg else ()
    wsh = NamedSharding(mesh, Spec(waxes))
    art = state.artemis
    opt_sh = map_tree(lambda _: rep, state.opt_state)
    if dcfg is not None and dcfg.bucketed:
        return TrainState(
            params=dict(pshard), opt_state=opt_sh,
            artemis=ArtemisDistState(
                h=map_tree(lambda _: wsh, art.h),
                hbar=map_tree(lambda _: rep, art.hbar),
                e=map_tree(lambda _: wsh, art.e),
                acc=map_tree(lambda _: wsh, art.acc),
                prev_active=wsh, step=rep),
            step=rep)
    shifted = [NamedSharding(mesh, Spec(waxes, *ns.spec))
               for ns in pshard.values()]

    def worker_tree(struct, full: bool):
        return list(shifted) if full else map_tree(lambda _: rep, struct)

    memory = dcfg is not None and dcfg.memory
    h_sh = worker_tree(art.h, memory)
    hbar_sh = (list(pshard.values()) if memory
               else map_tree(lambda _: rep, art.hbar))
    e_sh = worker_tree(art.e, dcfg is not None and dcfg.use_ef)
    acc_sh = worker_tree(art.acc, dcfg is not None and dcfg.local_steps > 1)
    return TrainState(
        params=dict(pshard), opt_state=opt_sh,
        artemis=ArtemisDistState(h=h_sh, hbar=hbar_sh, e=e_sh, acc=acc_sh,
                                 prev_active=wsh, step=rep),
        step=rep)


def default_alpha(params, s: int) -> float:
    """Thm 1 alpha, 1 / (2 (omega + 1)), at the largest omega over the
    leaves of ``params`` (a dict or a sequence of tensors): each leaf's
    message is its last axis (one element for a 0-d leaf)."""
    leaves = params.values() if isinstance(params, dict) else params
    return default_alpha_bucketed(
        max(leaf_row(tuple(leaf.shape)) for leaf in leaves), s)


def default_alpha_bucketed(row: int, s: int) -> float:
    """Thm 1 alpha for the bucketed wire: every row has length ``row``."""
    return float(1.0 / (2.0 * (wire.squant_omega(row, s) + 1.0)))


def _codec_alpha(cfg: DistConfig, rows) -> float:
    """Thm 1 alpha from the wire codec's omega (max over message rows)."""
    om = max(cfg.wire_codec(int(r)).omega for r in rows)
    return float(1.0 / (2.0 * (om + 1.0)))


def leaf_row(shape: Sequence[int]) -> int:
    """A leaf's message length: its last axis (1 for a 0-d leaf)."""
    return int(shape[-1]) if len(shape) else 1


def _rows(x: torch.Tensor, lead: int) -> torch.Tensor:
    """A 0-d leaf (``lead`` leading axes and nothing else) as one message of
    one element; other tensors as they are."""
    return x.unsqueeze(-1) if x.dim() == lead else x


def bucket_encode(buckets: torch.Tensor, u: torch.Tensor, s: int):
    """The row squant encode of a ``[B, R, C]`` bucket stack with the
    uniforms ``u`` of its shape: (levels int8 [B, R, C], scales f32 [B, R,
    1]).  The aggregates encode through ``bucketing.encode_buckets`` with
    any codec."""
    return wire.row_squant_encode(buckets, u, s)


def payload_decode(codec: wire.Codec,
                   payload: wire.WirePayload) -> torch.Tensor:
    """Decode a bucket-stacked payload (leaves with a leading B axis) to
    ``[B, R, C]`` f32."""
    return bucketing.decode_buckets(codec, payload)


def payload_nbytes(payload: wire.WirePayload) -> float:
    """Bytes of one worker's payload: every wire leaf's elements times its
    item size, over the leading (worker) axis."""
    total = sum(t.numel() * t.element_size() for t in payload.leaves())
    return float(total // payload.leaves()[0].shape[0])


def payload_specs(codec: wire.Codec, shape: Sequence[int]):
    """The fault draws' leaves of one message stack of ``shape`` (no worker
    axis): ((payload leaf shape, flipped-bit range), ...) in sorted-key
    order, as ``MeshNoise.step(leaves=...)`` takes them.  The encode runs
    on the meta device: shapes only, no arithmetic."""
    z = torch.zeros((1,) + tuple(shape), device="meta")
    payload = codec.encode(z, z)
    return tuple((tuple(t.shape[1:]), FLT.flip_bits(t.dtype))
                 for t in payload.leaves())


def wire_leaves(cfg: DistConfig, shapes) -> Tuple:
    """Every wire message's fault-draw leaves for a step of ``cfg`` over
    ``shapes`` (the bucket stack's [B, R, C], or the parameter leaves'
    shapes on the leaf wire); () unless the config flips bits."""
    if not (FLT.of(cfg.faults).bitflip_rate > 0.0 and cfg.up_compress):
        return ()
    if cfg.bucketed:
        return (payload_specs(cfg.wire_codec(shapes[-1]), shapes),)
    return tuple(payload_specs(cfg.wire_codec(leaf_row(s)),
                               tuple(s) if len(s) else (1,))
                 for s in shapes)


def _draws(source: MeshNoiseSource, cfg: DistConfig, k: int,
           leaves: Tuple) -> MeshDraws:
    """Step k's draws; the fault draws only for a config with faults."""
    if not FLT.of(cfg.faults).enabled:
        return source.step(k)
    return source.step(k, faults=True, leaves=leaves)


# ---------------------------------------------------------------------------
# the ring on the simulated worker axis
# ---------------------------------------------------------------------------

def _roll(payload: wire.WirePayload) -> wire.WirePayload:
    """One hop: worker w receives worker w-1's payload."""
    return payload.replace(**{k: torch.roll(v, 1, dims=0)
                              for k, v in payload.data.items()})


def bucket_ring_reduce(codec: wire.Codec, payload: wire.WirePayload,
                       n: int) -> torch.Tensor:
    """The pipelined ring over a ``[W, ..., R, C]`` payload stack: at hop j
    worker w folds in the payload of worker w - j, so it sums its own, then
    w-1's, w-2's, ...  The row-scale payload rides ``bucket_acc_hop_``:
    one accumulator, W launches in place, the hop's source worker in the
    kernel's index and no roll of the levels.  Any other codec takes the
    decode-then-add ring.  Returns every worker's sum, the payload's
    decoded shape."""
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


def leaf_ring_reduce(codec: wire.Codec, payload: wire.WirePayload,
                     n: int) -> torch.Tensor:
    """One leaf's ring over its ``[W, *shape]`` payload stack, worker 0's
    sum.  A row-scale payload folds each hop with ``bucket_acc_hop_`` over
    the ``[W, rows, C]`` view (a vector leaf is one row); any other codec
    decodes then adds."""
    if not codec.fused_acc:
        return bucket_ring_reduce_sequential(codec, payload, n)[0]
    q, scales = payload["levels"], payload["scales"]
    w, c = q.shape[0], q.shape[-1]
    view = payload.replace(levels=q.reshape(w, -1, c),
                           scales=scales.reshape(w, -1, 1))
    return bucket_ring_reduce(codec, view, n)[0].reshape(q.shape[1:])


class SimulatedAxis:
    """The W workers as the leading ``[W]`` axis of one device's tensors:
    each ring returns worker 0's sum."""

    def __init__(self, n_workers: int, reduce_impl: str = "pipelined"):
        self.n, self.reduce_impl = n_workers, reduce_impl

    def ring(self, codec: wire.Codec,
             payload: wire.WirePayload) -> torch.Tensor:
        if self.reduce_impl == "psum":
            return bucket_psum(codec, payload)
        if self.reduce_impl == "sequential":
            return bucket_ring_reduce_sequential(codec, payload, self.n)[0]
        return bucket_ring_reduce(codec, payload, self.n)[0]

    def leaf_ring(self, codec: wire.Codec,
                  payload: wire.WirePayload) -> torch.Tensor:
        return leaf_ring_reduce(codec, payload, self.n)

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)


# ---------------------------------------------------------------------------
# Artemis aggregation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArtemisDistState:
    """The mesh state.  Bucketed: one ``[W, B, R, C]`` stack each for
    ``h``, ``e`` and ``acc`` (a ``[W]`` stub when off) and ``hbar``
    ``[B, R, C]`` (0-d stub).  Leaf wire: lists in flatten order, ``[W,
    *leaf shape]`` and ``leaf shape`` (stubs ``[W]`` and 0-d)."""
    h: Any
    hbar: Any
    e: Any
    acc: Any
    prev_active: torch.Tensor  # [W] last step's availability
    step: int                  # communicating steps done


def init_dist_state(cfg: Optional[DistConfig], params: Sequence,
                    n_workers: int = 1, *, device=None) -> ArtemisDistState:
    """Zero state for ``params`` (tensors or shapes, in flatten order);
    ``cfg=None`` (no wire) gives the leaf wire's stubs, as the reference's
    does."""
    dev = default_device(device)
    if cfg is None:
        cfg = DistConfig(wire="leaf", variant="sgd")    # stubs everywhere
    mdt = getattr(torch, cfg.memory_dtype)

    def zeros(shape, dt=torch.float32):
        return torch.zeros(tuple(shape), dtype=dt, device=dev)

    if cfg.bucketed:
        shape = cfg.layout(params).shape
        full, stub = ((n_workers,) + shape,), ((n_workers,),)
        h, hbar = ((zeros(*full, mdt), zeros(shape, mdt)) if cfg.memory
                   else (zeros(*stub), zeros(())))
        e = zeros(*full) if cfg.use_ef else zeros(*stub)
        acc = zeros(*full) if cfg.local_steps > 1 else zeros(*stub)
    else:
        shapes = [tuple(p.shape) if isinstance(p, torch.Tensor)
                  else tuple(p) for p in params]

        def stacks(on, dt=torch.float32):
            return [zeros((n_workers,) + (s if on else ()), dt)
                    for s in shapes]

        h = stacks(cfg.memory, mdt if cfg.memory else torch.float32)
        hbar = [zeros(s if cfg.memory else (),
                      mdt if cfg.memory else torch.float32) for s in shapes]
        e = stacks(cfg.use_ef)
        acc = stacks(cfg.local_steps > 1)
    return ArtemisDistState(h=h, hbar=hbar, e=e, acc=acc,
                            prev_active=zeros((n_workers,)), step=0)


def _masks(cfg: DistConfig, state: ArtemisDistState, draws: MeshDraws,
           lead: int, device):
    """(active, part) [L]: this step's availability (the Markov chain's
    next state) and who made the deadline, as ``_round_keys`` draws them."""
    fc, p = FLT.of(cfg.faults), cfg.p_participation
    if p < 1.0 or fc.markov:
        part = FLT.participation(fc, p, draws.u_act, state.prev_active,
                                 state.step)
    else:
        part = torch.ones(lead, device=device)
    active = part
    if fc.straggler_rate > 0.0:
        # available, but missed the deadline
        active = active * (draws.u_strag >= fc.straggler_rate).to(
            active.dtype)
    return active, part


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (like.dim() - mask.dim()))


def _all_finite(x: torch.Tensor) -> torch.Tensor:
    """[L] 1.0 where the worker's whole tensor is finite."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(-1).to(
        torch.float32)


def message_valid(codec: wire.Codec, payload: wire.WirePayload,
                  lead: int) -> torch.Tensor:
    """The checksum per unit of the ``lead`` leading axes: 1.0 where every
    message of the unit passes ``codec.validate``."""
    v = codec.validate(payload) > 0
    return v.reshape(tuple(v.shape[:lead]) + (-1,)).all(-1).to(
        torch.float32)


def _obs(wire_bytes: float, active, scrubbed, blow, device) -> Dict:
    zero = torch.zeros((), device=device)
    return {"wire_bytes": float(wire_bytes),
            "mesh_active": active.sum(),
            "mesh_scrubbed": zero if scrubbed is None else scrubbed,
            "mesh_blowup_hits": zero if blow is None
            else blow.to(torch.float32).sum()}


def bucketed_aggregate(cfg: DistConfig, state: ArtemisDistState,
                       gbuckets: torch.Tensor,
                       layout: bucketing.BucketLayout, axis,
                       draws: MeshDraws):
    """The bucketed aggregate of the L local workers of ``axis``
    (``SimulatedAxis``: all W; a process-group rank: one), ``gbuckets [L,
    B, R, C]``, with the L workers' ``draws``.  Returns (the descent
    direction ``[B, R, C]``, the new state, the obs totals over the L
    workers or None)."""
    n, lead, dev = axis.n, gbuckets.shape[0], gbuckets.device
    fc = FLT.of(cfg.faults)
    wc = cfg.wire_codec(layout.row)
    alpha = cfg.alpha if cfg.alpha is not None else (
        _codec_alpha(cfg, [layout.row]) if cfg.memory else 0.0)
    p = cfg.p_participation
    mdt = getattr(torch, cfg.memory_dtype)

    with spans.phase("wire/memory"):
        active, part = _masks(cfg, state, draws, lead, dev)
        g32 = gbuckets.to(torch.float32)
        hit = scrubbed = None
        if fc.blowup_rate > 0.0:
            hit = FLT.blowup_mask(fc, draws.u_blow)
            g32 = FLT.apply_blowup(fc, hit, g32)
        if fc.scrub:
            # a non-finite gradient masks its worker before any arithmetic,
            # and is zeroed (0 * NaN is NaN)
            active = active * _all_finite(g32)
            g32 = FLT.nan_to_zero(g32)
        act = _bcast(active, g32)
        h = (state.h.to(torch.float32) if cfg.memory
             else torch.zeros_like(g32))
        delta = (g32 - h) * act
        if cfg.use_ef:
            delta = delta + state.e

    ok = act
    if cfg.up_compress:
        with spans.phase("wire/encode"):
            enc = bucketing.encode_buckets(wc, delta, draws.u_up)
            # PP2: an inactive worker's payload (its EF buffer under Dore)
            # must add exactly zero to the sum
            enc = FLT.mask_payload(enc, active)
            if fc.bitflip_rate > 0.0:
                # only a payload that was sent picks up flipped bits
                enc = FLT.corrupt_payload(draws.flips[0], enc,
                                          fc.bitflip_rate, only=active)
            if fc.scrub:
                # a checksum per bucket: a corrupt bucket is dropped
                # through the zero-scale path, its h and e slices stay put
                valid = message_valid(wc, enc, 2)            # [L, B]
                ok = act * _bcast(valid, g32)
                enc = FLT.scrub_payload(enc, valid)
                scrubbed = valid.numel() - valid.sum()
        wire_bytes = lead * (4.0 * layout.padded_total
                             if cfg.reduce_impl == "psum"
                             else (n - 1) * payload_nbytes(enc))
        with spans.phase("wire/ring", wire_bytes=wire_bytes):
            dhat_sum = axis.ring(wc, enc)
        with spans.phase("wire/decode"):
            dhat_i = bucketing.decode_buckets(wc, enc)
    else:
        with spans.phase("wire/memory"):
            dhat_i = delta * act
        wire_bytes = lead * 4.0 * layout.padded_total
        with spans.phase("wire/ring", wire_bytes=wire_bytes):
            dhat_sum = axis.dense(dhat_i)

    with spans.phase("wire/memory"):
        e_new = (ok * (delta - dhat_i) + (1 - ok) * state.e
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
        # the zero-byte broadcast: one key, one compression for all
        with spans.phase("wire/downlink"):
            ghat = bucketing.decode_buckets(
                wc, bucketing.encode_buckets(wc, ghat, draws.u_dwn))
    new = ArtemisDistState(h_new, hbar_new, e_new, state.acc, part,
                           state.step + 1)
    obs = (_obs(wire_bytes, active, scrubbed, hit, dev)
           if cfg.telemetry else None)
    return ghat, new, obs


def leaf_aggregate(cfg: DistConfig, state: ArtemisDistState,
                   grads: Sequence[torch.Tensor], axis, draws: MeshDraws):
    """The leaf wire's aggregate of the L local workers of ``axis``: the
    per-leaf gradient stacks ``[L, *leaf shape]`` in flatten order ->
    (the descent direction per leaf, the new state, the obs totals or
    None)."""
    with spans.phase("wire"):
        return _leaf_aggregate(cfg, state, grads, axis, draws)


def _leaf_aggregate(cfg: DistConfig, state: ArtemisDistState,
                    grads: Sequence[torch.Tensor], axis, draws: MeshDraws):
    n, lead = axis.n, grads[0].shape[0]
    dev = grads[0].device
    fc = FLT.of(cfg.faults)
    active, part = _masks(cfg, state, draws, lead, dev)
    hit = scrubbed = None
    if fc.blowup_rate > 0.0:
        hit = FLT.blowup_mask(fc, draws.u_blow)
    rows = [leaf_row(g.shape[1:]) for g in grads]
    alpha = cfg.alpha if cfg.alpha is not None else (
        _codec_alpha(cfg, rows) if cfg.memory else 0.0)
    p = cfg.p_participation
    mdt = getattr(torch, cfg.memory_dtype)
    wire_bytes = 0.0
    out_agg, out_h, out_hbar, out_e = [], [], [], []
    for i, (g, row) in enumerate(zip(grads, rows)):
        g32 = g.to(torch.float32)
        act_l = active
        if hit is not None:
            g32 = FLT.apply_blowup(fc, hit, g32)
        if fc.scrub:
            # a non-finite leaf: this worker sits the leaf's ring out
            act_l = act_l * _all_finite(g32)
            g32 = FLT.nan_to_zero(g32)
        act = _bcast(act_l, g32)
        h = state.h[i].to(torch.float32) if cfg.memory \
            else torch.zeros_like(g32)
        delta = (g32 - h) * act
        if cfg.use_ef:
            delta = delta + state.e[i]
        ok = act
        if cfg.up_compress:
            wcl = cfg.wire_codec(row)
            enc = wcl.encode(_rows(delta, 1), _rows(draws.u_up[i], 1))
            enc = FLT.mask_payload(enc, act_l)
            if fc.bitflip_rate > 0.0:
                enc = FLT.corrupt_payload(draws.flips[i], enc,
                                          fc.bitflip_rate, only=act_l)
            if fc.scrub:
                # a checksum per leaf, dropped through the zero-scale path
                valid = message_valid(wcl, enc, 1)           # [L]
                ok = act * _bcast(valid, g32)
                enc = FLT.scrub_payload(enc, valid)
                miss = lead - valid.sum()
                scrubbed = miss if scrubbed is None else scrubbed + miss
            dhat_sum = axis.leaf_ring(wcl, enc).reshape(g.shape[1:])
            dhat_i = wcl.decode(enc).reshape(g.shape)
            wire_bytes += (n - 1) * payload_nbytes(enc)
        else:
            dhat_i = delta * act
            dhat_sum = axis.dense(dhat_i)
            wire_bytes += 4.0 * g[0].numel()
        out_e.append(ok * (delta - dhat_i) + (1 - ok) * state.e[i]
                     if cfg.use_ef else state.e[i])
        if cfg.memory:
            hbar = state.hbar[i].to(torch.float32)
            ghat = hbar + dhat_sum / (p * n)
            out_h.append((h + alpha * dhat_i).to(mdt))
            out_hbar.append((hbar + alpha * dhat_sum / n).to(mdt))
        else:
            ghat = dhat_sum / (p * n)
            out_h.append(state.h[i])
            out_hbar.append(state.hbar[i])
        if cfg.dwn_compress:
            # the zero-byte broadcast: one key, one compression for all
            wcd = cfg.wire_codec(row)
            ghat = wcd(_rows(ghat, 0), _rows(draws.u_dwn[i], 0)).reshape(
                ghat.shape)
        out_agg.append(ghat.to(g.dtype))
    new = ArtemisDistState(out_h, out_hbar, out_e, state.acc, part,
                           state.step + 1)
    obs = (_obs(lead * wire_bytes, active, scrubbed, hit, dev)
           if cfg.telemetry else None)
    return out_agg, new, obs


def _returns(cfg: DistConfig, out):
    agg, new, obs = out
    return (agg, new, obs) if cfg.telemetry else (agg, new)


def artemis_aggregate_bucketed(cfg: DistConfig, state: ArtemisDistState,
                               gbuckets: torch.Tensor,
                               layout: bucketing.BucketLayout,
                               n_workers: int, draws: MeshDraws):
    """Per-worker gradient buckets ``[W, B, R, C]`` -> (the descent
    direction ``[B, R, C]``, the new state), and the obs dict when
    ``cfg.telemetry``, with this step's ``draws``."""
    return _returns(cfg, bucketed_aggregate(
        cfg, state, gbuckets, layout,
        SimulatedAxis(n_workers, cfg.reduce_impl), draws))


def artemis_aggregate(cfg: DistConfig, state: ArtemisDistState,
                      grads: Sequence[torch.Tensor], n_workers: int,
                      draws: MeshDraws):
    """The leaf wire: per-worker gradient stacks ``[W, *leaf shape]`` in
    flatten order -> (the descent direction per leaf, the new state), and
    the obs dict when ``cfg.telemetry``, with this step's ``draws``."""
    return _returns(cfg, leaf_aggregate(
        cfg, state, grads, SimulatedAxis(n_workers, cfg.reduce_impl),
        draws))


# ---------------------------------------------------------------------------
# train-step factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Any
    artemis: ArtemisDistState
    step: int


def vmap_grads(model) -> Callable:
    """The default per-worker gradients: ``torch.func.vmap`` of the loss's
    gradient over the batch split into W contiguous blocks (the
    reference's ``P(worker_axes)`` batch spec), the parameters shared.
    Returns (grads {name: [W, *shape]}, (loss [W], metrics {k: [W]}))."""
    fn = torch.func.grad_and_value(model.loss, has_aux=True)
    vfn = torch.func.vmap(fn, in_dims=(None, 0))

    def grads(params: Params, split: Dict[str, torch.Tensor]):
        return vfn(params, split)
    return grads


def _split(batch: Dict[str, torch.Tensor], n_workers: int):
    return {k: v.reshape((n_workers, -1) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _worker_grads(grad_fn, dcfg: DistConfig, params: Params,
                  batch: Dict[str, torch.Tensor], n_workers: int):
    """Each worker's gradient: a ``[W, B, R, C]`` bucket stack (bucketed
    wire) or the per-leaf ``[W, *shape]`` stacks (leaf wire), with the
    workers' mean loss and metrics (the reference's pmean)."""
    with spans.phase("grads"):
        grads, (loss, metrics) = grad_fn(params, _split(batch, n_workers))
    leaves = [grads[k] for k in params]
    if dcfg.bucketed:
        with spans.phase("wire/bucketize"):
            leaves = bucketing.bucketize(
                dcfg.layout(list(params.values())), leaves)
    return leaves, (loss.mean(), {k: v.mean() for k, v in metrics.items()})


def make_local_step(model, dcfg: DistConfig, n_workers: int, *,
                    grad_fn: Optional[Callable] = None):
    """Accumulate-only step for ``local_steps > 1``: run it k-1 times
    between ``make_train_step``'s communicating steps.  It adds each
    worker's gradient to its accumulator (in bucket space on the bucketed
    wire, per leaf on the leaf wire) and moves nothing over the wire.
    ``grad_fn``: the per-worker gradients (``vmap_grads``'s contract), by
    default ``vmap_grads(model)``."""
    if dcfg.local_steps < 2:
        raise ValueError("make_local_step needs local_steps > 1")
    grad_fn = vmap_grads(model) if grad_fn is None else grad_fn

    def local_fn(state: TrainState, batch):
        g, out = _worker_grads(grad_fn, dcfg, state.params, batch, n_workers)
        return accumulate_local(dcfg, state, g), out

    return local_fn


def accumulate_local(dcfg: DistConfig, state: TrainState, g) -> TrainState:
    """``state`` with the gradients ``g`` (the ``[W, B, R, C]`` bucket stack,
    or the per-leaf ``[W, *shape]`` stacks) added to its accumulator."""
    art = state.artemis
    acc = (art.acc + g if dcfg.bucketed
           else [a + x.to(a.dtype) for a, x in zip(art.acc, g)])
    return dataclasses.replace(state,
                               artemis=dataclasses.replace(art, acc=acc))


def _fold_local(dcfg: DistConfig, art: ArtemisDistState, g):
    """Fold the gradients accumulated since the last sync into this step's
    (``local_steps`` > 1): ``(acc + g) / k`` and a zeroed accumulator."""
    k = dcfg.local_steps
    if dcfg.bucketed:
        return ((art.acc + g) / k,
                dataclasses.replace(art, acc=torch.zeros_like(art.acc)))
    return ([(a + x) / k for a, x in zip(art.acc, g)],
            dataclasses.replace(art, acc=[torch.zeros_like(a)
                                          for a in art.acc]))


def make_train_step(model, optimizer, dcfg: Optional[DistConfig],
                    n_workers: int = 1, device=None, *,
                    noise: Optional[MeshNoiseSource] = None,
                    grad_fn: Optional[Callable] = None):
    """Build ``(init_state, step_fn)`` for W = ``n_workers`` simulated
    workers on ``device`` (CUDA unless the caller names another).

    ``dcfg=None`` is the reference's plain data-parallel baseline: the
    whole batch's gradient, no wire, the optimizer step, and
    ``artemis.step + 1`` (the state holds the leaf wire's stubs);
    ``n_workers``, ``noise`` and ``grad_fn`` do not apply.

    ``init_state(params)`` takes the params dict (the model's leaf names
    in flatten order).  ``step_fn(state, batch) -> (state, (loss,
    metrics))`` is one communicating step; loss and metrics are the
    workers' mean, and ``metrics["obs"]`` the obs totals when
    ``dcfg.telemetry``.  ``noise``: the source of each step's draws, by
    default ``MeshNoise(dcfg.seed, ...)`` on the device.  ``grad_fn``: the
    per-worker gradients (``vmap_grads``'s contract), by default
    ``vmap_grads(model)``.
    """
    dev = default_device(device)
    source = noise

    def init_state(params: Params) -> TrainState:
        plist = list(params.values())
        return TrainState(params=dict(params),
                          opt_state=optimizer.init(plist),
                          artemis=init_dist_state(dcfg, plist, n_workers,
                                                  device=dev),
                          step=0)

    def _apply(state, agg, art, loss, metrics):
        with spans.phase("optim"):
            updates, opt_state = optimizer.update(agg, state.opt_state,
                                                  state.step)
            with spans.phase("optim/apply"):
                params = {k: p - u.to(p.dtype)
                          for (k, p), u in zip(state.params.items(),
                                               updates)}
        return TrainState(params, opt_state, art, state.step + 1), (loss,
                                                                    metrics)

    if dcfg is None:
        value_grad = torch.func.grad_and_value(model.loss, has_aux=True)

        def plain_step(state: TrainState, batch):
            with spans.phase("step", step=state.step):
                with spans.phase("grads"):
                    grads, (loss, metrics) = value_grad(state.params, batch)
                return _apply(state, list(grads.values()),
                              dataclasses.replace(
                                  state.artemis,
                                  step=state.artemis.step + 1),
                              loss, metrics)

        return init_state, plain_step

    grad_fn = vmap_grads(model) if grad_fn is None else grad_fn
    shapes = leaves = None

    def step_fn(state: TrainState, batch):
        with spans.phase("step", step=state.step):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        nonlocal source, shapes, leaves
        plist = list(state.params.values())
        if shapes is None:
            shapes = (dcfg.layout(plist).shape if dcfg.bucketed
                      else [tuple(p.shape) for p in plist])
            leaves = wire_leaves(dcfg, shapes)
        if source is None:
            source = MeshNoise(dcfg.seed, n_workers, shapes, dev)
        g, (loss, metrics) = _worker_grads(grad_fn, dcfg, state.params,
                                           batch, n_workers)
        art = state.artemis
        if dcfg.local_steps > 1:
            g, art = _fold_local(dcfg, art, g)
        with spans.phase("wire/noise"):
            draws = _draws(source, dcfg, art.step, leaves)
        axis = SimulatedAxis(n_workers, dcfg.reduce_impl)
        if dcfg.bucketed:
            layout = dcfg.layout(plist)
            ghat, art, obs = bucketed_aggregate(dcfg, art, g, layout, axis,
                                                draws)
            with spans.phase("wire/unbucketize"):
                agg = bucketing.unbucketize(layout, ghat, like=plist)
        else:
            agg, art, obs = leaf_aggregate(dcfg, art, g, axis, draws)
        if obs is not None:
            metrics = {**metrics, "obs": obs}
        return _apply(state, agg, art, loss, metrics)

    return init_state, step_fn
