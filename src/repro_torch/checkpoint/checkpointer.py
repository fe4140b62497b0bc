"""A minimal checkpointer: an npz payload and a JSON manifest (port of
``repro/checkpoint/checkpointer.py``).

A tree is nested dicts, lists, tuples and dataclasses (a ``TrainState``,
an ``ArtemisDistState``: their fields in declaration order) of tensors,
numpy arrays or Python numbers; it is saved as flat npz entries keyed by
its path (``"carry/v0/w"``), a Python number as a 0-d entry.  Tensors go
to the host (``.cpu()``) on save and back to the device of the matching
leaf of ``like`` on restore, a number comes back as a number of its type.  numpy and json only: nothing is pickled, and
``np.load`` is called with ``allow_pickle=False``.

Layout: one ``step_XXXXXXXX`` directory per save and a ``LATEST`` pointer.
Every file (``arrays.npz``, ``manifest.json``, ``LATEST``) is written to a
temporary name and renamed atomically, and ``LATEST`` moves only after the
step directory is complete, so a process killed mid-save leaves the
previous checkpoint readable and no temporary file behind a finished save.
``restore`` checks the manifest's keys, shapes and dtypes against the
target tree first and raises one ``ValueError`` listing every mismatch.

On a device mesh a leaf may be a DTensor: ``save`` writes it whole (every
rank of its mesh joins the gather; ``write=False`` for the ranks that only
join), and ``restore`` places each leaf back on a mesh, at ``shardings``
(a tree like ``like`` of ``launch/mesh.NamedSharding``, None for a leaf to
leave plain) or where a DTensor leaf of ``like`` was placed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.model import flatten_params

Tree = Any

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _fields(tree) -> Optional[list]:
    """A dataclass instance's (name, value) pairs, else None."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _safe(key) -> str:
    return _SAFE.sub("_", str(key))


def _flatten(tree: Tree) -> Dict[str, Any]:
    """{path: leaf} in the tree's own order (dict keys sorted), each key
    made safe for an npz entry's name; a bare leaf is ``"_root"``."""
    return {k or "_root": v
            for k, v in flatten_params(tree, name=_safe).items()}


def _unflatten(like: Tree, leaves: Dict[str, Any], prefix: str = "") -> Tree:
    fields = _fields(like)
    if fields is not None:
        return dataclasses.replace(like, **{
            k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
            for k, v in fields})
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{_safe(k)}"
                              if prefix else _safe(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(like)]
        return type(like)(vals)
    return leaves[prefix or "_root"]


def _host(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()             # a collective over its mesh
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype to save")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return np.dtype(str(x.dtype).removeprefix("torch."))
    return np.asarray(x).dtype


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _atomic_write(path: str, write_fn) -> None:
    """Write via a same-directory temporary file and an atomic rename."""
    tmp = path + f".tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save(ckpt_dir: str, step: int, tree: Tree,
         extra: Optional[dict] = None, *, write: bool = True) -> str:
    """Save ``tree`` as step ``step`` of ``ckpt_dir``; returns the step's
    directory.  ``extra`` (JSON-serialisable) rides in the manifest.
    DTensor leaves are gathered whole first; ``write=False`` joins those
    gathers and writes nothing."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    arrays = {k: _host(v) for k, v in _flatten(tree).items()}
    if not write:
        return d
    os.makedirs(d, exist_ok=True)

    def _write_npz(tmp):
        # np.savez appends .npz to a name without it: write to a handle
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    _atomic_write(os.path.join(d, "arrays.npz"), _write_npz)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "extra": extra or {},
    }

    def _write_json(tmp):
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)

    _atomic_write(os.path.join(d, "manifest.json"), _write_json)

    def _write_latest(tmp):
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())

    # LATEST moves last: a reader never sees a pointer to a partial step
    _atomic_write(os.path.join(ckpt_dir, "LATEST"), _write_latest)
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest of ``step`` (default: LATEST), without the arrays."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"missing manifest: {path}")
    with open(path) as f:
        return json.load(f)


def _validate(manifest: dict, flat_like: dict, where: str) -> None:
    keys, like_keys = set(manifest["keys"]), set(flat_like)
    problems = []
    missing = sorted(like_keys - keys)
    unexpected = sorted(keys - like_keys)
    if missing:
        problems.append(f"missing keys {missing}")
    if unexpected:
        problems.append(f"unexpected keys {unexpected}")
    for k in sorted(like_keys & keys):
        ref = flat_like[k]
        shape = tuple(manifest["shapes"][k])
        dtype = np.dtype(manifest["dtypes"][k])
        if shape != _shape(ref):
            problems.append(f"{k}: shape {shape} != expected "
                            f"{_shape(ref)}")
        if dtype != _dtype(ref):
            problems.append(f"{k}: dtype {dtype} != expected {_dtype(ref)}")
    if problems:
        raise ValueError(f"checkpoint {where} does not match the restore "
                         f"target:\n  " + "\n  ".join(problems))


def restore(ckpt_dir: str, like: Tree, step: Optional[int] = None,
            shardings: Optional[Tree] = None) -> Tree:
    """Restore step ``step`` (default: LATEST) into the structure of
    ``like``: a tensor leaf comes back as a tensor on that leaf's device, a
    numpy leaf as a numpy array, a Python number as one.  A leaf with a
    sharding in ``shardings`` (a tree like ``like``; None: none) comes back
    as a DTensor placed by it, and so does a DTensor leaf of ``like``,
    where it was placed.  Raises ``ValueError`` if the manifest disagrees
    with ``like`` on keys, shapes or dtypes."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat_like = _flatten(like)
    _validate(read_manifest(ckpt_dir, step), flat_like, d)
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import distribute
    placed = {}
    if shardings is not None:
        placed = {k: v for k, v in _flatten(shardings).items()
                  if v is not None}
    leaves = {}
    with np.load(os.path.join(d, "arrays.npz"), allow_pickle=False) as data:
        for key, ref in flat_like.items():
            a = data[key]
            if key in placed:
                dev = (ref.to_local().device if isinstance(ref, DTensor)
                       else ref.device)
                leaves[key] = distribute(torch.from_numpy(a).to(dev),
                                         placed[key])
            elif isinstance(ref, DTensor):
                leaves[key] = _redistribute_like(a, ref)
            elif isinstance(ref, torch.Tensor):
                leaves[key] = torch.from_numpy(a).to(ref.device)
            elif isinstance(ref, (bool, int, float)):
                leaves[key] = type(ref)(a.item())
            else:
                leaves[key] = a
    return _unflatten(like, leaves)


def _redistribute_like(a: np.ndarray, ref):
    """The whole array ``a`` as a DTensor placed as the DTensor ``ref``."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    x = torch.from_numpy(a).to(ref.to_local().device)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh,
                                                            ref.placements)
