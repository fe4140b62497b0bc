"""The production mesh and the sharding policy (port of
``repro/launch/mesh.py``), over ``torch.distributed``'s ``DeviceMesh`` and
``DTensor`` placements.

Mesh axes:
  multi-pod  : (pod=2, data=16, model=16), 512 ranks; ``pod`` is the Artemis
               worker axis (the paper's bandwidth-bound uplink).
  single-pod : (data=16, model=16), 256 ranks; Artemis (when on) uses
               ``data`` as the worker axis.

A ``Spec`` is the counterpart of ``jax.sharding.PartitionSpec``: one entry
per tensor dim (trailing dims may be left out), each ``None``, an axis name
or a tuple of axis names.  ``to_placements`` turns it into one placement
per mesh dim: ``Shard(d)`` on every mesh axis that tensor dim ``d`` names,
``Replicate()`` elsewhere.  A dim split over ``("pod", "data")`` is split
pod-major, as JAX splits it (DTensor shards over the mesh dims in order).

Parameter policy (the reference's rules, unchanged): 2-D sharding of the
big matrices over (data, model), experts over model where the expert count
divides it (else 2-D over the expert's own matrices), output projections
contracting over model, the vocabulary dim never sharded.  A dim the axis
does not divide stays whole (``_maybe``).

Parameter paths are the flat params dict's keys, which are the reference's
``/``-joined tree paths (``models/model.flatten_params``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch import default_device

AxisEntry = Optional[object]        # None | str | tuple of str


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a list as a tuple, a
    tuple of one axis as that axis, an empty tuple as None."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return e[0] if len(e) == 1 else (e or None)
    return e


class Spec(tuple):
    """A partition spec: ``Spec(None, "model")``, ``Spec(("pod",
    "data"))``, ``Spec()`` (replicated); entries normalised as
    ``PartitionSpec`` normalises them (``_entry``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``);
    ``placements`` are DTensor's.  A leaf of the trees it sits in, not a
    node."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: DeviceMesh, spec: Sequence[AxisEntry]):
        self.mesh, self.spec = mesh, Spec(*spec)

    @property
    def placements(self) -> list:
        return to_placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over the default process group
    (256 or 512 ranks), on CUDA unless ``device_type`` names another
    device type."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(default_device(device_type).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None, axes=None,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A small mesh over the default process group's ranks (tests,
    examples): ``(world, 1)`` ``("data", "model")`` by default, on CUDA
    unless ``device_type`` names another device type."""
    if shape is None:
        shape = (torch.distributed.get_world_size(), 1)
        axes = ("data", "model")
    return init_device_mesh(default_device(device_type).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def axis_names(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def _maybe(mesh: DeviceMesh, axis: Optional[str], dim: int) -> Optional[str]:
    """Use ``axis`` only if it exists and divides ``dim``."""
    if axis is None or axis not in axis_names(mesh):
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def to_placements(mesh: DeviceMesh, spec: Sequence[AxisEntry]) -> list:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``
    names the mesh axis, ``Replicate()`` elsewhere.  A dim over several
    axes must name them in mesh order (JAX's major-to-minor split)."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes if a in names]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in pos:
            out[i] = Shard(d)
    return out


def param_spec(mesh: DeviceMesh, path: str, shape: Tuple[int, ...],
               data_axis: str = "data", model_axis: str = "model") -> Spec:
    """The spec of one parameter leaf (``path`` its ``/``-joined key)."""
    nd = len(shape)
    if "moe" in path and nd >= 3:
        # [(L,) E, d_in, d_out]: experts over model when E divides it,
        # else 2-D (d_in x d_out) sharding of each expert's matrices
        spec = [None] * nd
        out_proj = path.endswith("w_down")
        if _maybe(mesh, model_axis, shape[-3]):
            spec[-3] = model_axis
            spec[-2] = _maybe(mesh, data_axis, shape[-2])
        elif out_proj:   # contract the wide dim over model (below)
            spec[-2] = _maybe(mesh, model_axis, shape[-2])
            spec[-1] = _maybe(mesh, data_axis, shape[-1])
        else:
            spec[-2] = _maybe(mesh, data_axis, shape[-2])
            spec[-1] = _maybe(mesh, model_axis, shape[-1])
        return Spec(*spec)
    if path.endswith("embed") and nd == 2:       # [V, d]
        # the vocabulary dim is never sharded; the feature dim over model
        return Spec(None, _maybe(mesh, model_axis, shape[1]))
    if nd >= 2 and shape[-1] >= 128 and shape[-2] >= 128:
        # input projections contract d_model over data and expand over
        # model; output projections contract the wide dim over model
        out_proj = any(path.endswith(sfx) for sfx in
                       ("w_down", "wo", "out_proj", "rg/out", "dt_proj"))
        a, b = (model_axis, data_axis) if out_proj else (data_axis,
                                                         model_axis)
        spec = [None] * nd
        spec[-2] = _maybe(mesh, a, shape[-2])
        spec[-1] = _maybe(mesh, b, shape[-1])
        return Spec(*spec)
    if nd >= 1 and shape[-1] >= 1024:            # wide vectors (A_log, D)
        spec = [None] * nd
        spec[-1] = _maybe(mesh, model_axis, shape[-1])
        return Spec(*spec)
    return Spec()


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def params_specs(mesh: DeviceMesh, params: Dict, **kw) -> Dict[str, Spec]:
    """``param_spec`` of every leaf of a flat params dict (tensors or
    shapes)."""
    return {k: param_spec(mesh, k, _shape(v), **kw)
            for k, v in params.items()}


def params_shardings(mesh: DeviceMesh, params: Dict,
                     **kw) -> Dict[str, NamedSharding]:
    """The sharding of every leaf of a flat params dict."""
    return {k: NamedSharding(mesh, s)
            for k, s in params_specs(mesh, params, **kw).items()}


def batch_spec(mesh: DeviceMesh, shape: Tuple[int, ...],
               batch_axes=("pod", "data")) -> Spec:
    names = axis_names(mesh)
    axes = tuple(a for a in batch_axes if a in names)
    if not axes:
        return Spec()
    total = math.prod(_axis_size(mesh, a) for a in axes)
    if shape[0] % total != 0:
        # fall back to axes that divide
        for sub in (("data",), ()):
            t = math.prod(_axis_size(mesh, a) for a in sub) if sub else 1
            if shape[0] % t == 0:
                return Spec(sub if sub else None)
    return Spec(axes)


def batch_shardings(mesh: DeviceMesh, batch: Dict,
                    batch_axes=("pod", "data")) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, batch_spec(mesh, _shape(v), batch_axes))
            for k, v in batch.items()}


def strip_axes(spec: Sequence[AxisEntry], banned: Tuple[str, ...]) -> Spec:
    """``spec`` without the worker (manual) axes."""
    def clean(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a not in banned)
            return kept if kept else None
        return None if e in banned else e
    return Spec(*(clean(e) for e in spec))


def layer_spec(mesh: DeviceMesh, path: str, shape: Tuple[int, ...],
               banned_axes: Tuple[str, ...] = ()) -> Spec:
    """The spec of one layer's slice of a stacked leaf: the stacked spec
    minus its leading layer dim, padded to the slice's rank, without the
    banned axes (the reference's ``layer_constraint_fn`` rule)."""
    stacked = tuple(param_spec(mesh, path, (0,) + tuple(shape)))
    spec = stacked[1:] if len(stacked) > 1 else ()
    spec = spec + (None,) * (len(shape) - len(spec))
    return strip_axes(spec, banned_axes)


def layer_constraint_fn(mesh: DeviceMesh,
                        banned_axes: Tuple[str, ...] = ()):
    """``Model.layer_constraint``: each leaf of a layer's slice (a DTensor)
    redistributed to ``layer_spec`` on its own mesh; a plain tensor is left
    as it is."""
    def constrain(p_slice: Dict) -> Dict:
        return {k: _constrain(v, layer_spec(mesh, k, tuple(v.shape),
                                            banned_axes))
                for k, v in p_slice.items()}
    return constrain


def act_constraint_fn(mesh: DeviceMesh, banned_axes: Tuple[str, ...] = (),
                      batch_axes=("pod", "data")):
    """``Model.act_constraint``: activations ``[B, S, d]`` with the batch
    over the (non-worker) data axes, when they divide it."""
    names = axis_names(mesh)
    axes = tuple(a for a in batch_axes
                 if a in names and a not in banned_axes)

    def constrain(x):
        if not axes or x.dim() < 2 or x.shape[0] % math.prod(
                _axis_size(mesh, a) for a in axes):
            return x
        return _constrain(x, Spec(axes, *([None] * (x.dim() - 1))))
    return constrain


def _constrain(x, spec: Sequence[AxisEntry]):
    """A DTensor redistributed to ``spec`` over the axes of its own mesh
    (the counterpart of ``with_sharding_constraint``: entries naming axes
    the mesh lacks are dropped); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = set(axis_names(mesh))
    spec = strip_axes(spec, tuple(
        a for e in spec if e is not None
        for a in (e if isinstance(e, tuple) else (e,)) if a not in names))
    want = to_placements(mesh, spec)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, want)


def cache_spec(mesh: DeviceMesh, path: str, shape: Tuple[int, ...],
               batch_axes=("pod", "data")) -> Spec:
    """KV caches ``[L, B, CL, KV, hd]``: the batch over the data axes and
    the widest trailing dim over model; SSM states ``[L, B, ...]`` alike."""
    nd = len(shape)
    if nd >= 2:
        names = axis_names(mesh)
        spec = [None] * nd
        b_ax = tuple(a for a in batch_axes if a in names)
        total = math.prod(_axis_size(mesh, a) for a in b_ax) if b_ax else 1
        if b_ax and shape[1] % total == 0:
            spec[1] = b_ax
        elif "data" in names and shape[1] % _axis_size(mesh, "data") == 0:
            spec[1] = "data"
        # the widest trailing dim over model (the first of equals)
        if nd > 2:
            tail = list(shape[2:])
            cand = tail.index(max(tail)) + 2
            spec[cand] = _maybe(mesh, "model", shape[cand])
        return Spec(*spec)
    return Spec()


def cache_specs(mesh: DeviceMesh, cache: Dict, **kw) -> Dict[str, Spec]:
    """``cache_spec`` of every leaf of a flat cache dict."""
    return {k: cache_spec(mesh, k, _shape(v), **kw)
            for k, v in cache.items()}


def cache_shardings(mesh: DeviceMesh, cache: Dict,
                    **kw) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, s)
            for k, s in cache_specs(mesh, cache, **kw).items()}


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """A tensor that every rank holds whole, as a DTensor placed by
    ``sharding``: each rank keeps a copy of its own block, and the whole
    is not kept (no communication).  A DTensor is redistributed."""
    from torch.distributed.tensor import DTensor
    mesh, want = sharding.mesh, sharding.placements
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == tuple(want) else \
            x.redistribute(mesh, want)
    placed = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                run_check=False).redistribute(mesh, want)
    return DTensor.from_local(placed.to_local().clone(), mesh, want,
                              run_check=False, shape=placed.shape,
                              stride=placed.stride())
