"""A minimal checkpointer: an npz payload and a JSON manifest (port of
``repro/checkpoint/checkpointer.py``).

A tree is nested dicts, lists and tuples of tensors or numpy arrays; it is
saved as flat npz entries keyed by its path (``"carry/v0/w"``).  Tensors go
to the host (``.cpu()``) on save and back to the device of the matching
leaf of ``like`` on restore.  numpy and json only: nothing is pickled, and
``np.load`` is called with ``allow_pickle=False``.

Layout: one ``step_XXXXXXXX`` directory per save and a ``LATEST`` pointer.
Every file (``arrays.npz``, ``manifest.json``, ``LATEST``) is written to a
temporary name and renamed atomically, and ``LATEST`` moves only after the
step directory is complete, so a process killed mid-save leaves the
previous checkpoint readable and no temporary file behind a finished save.
``restore`` checks the manifest's keys, shapes and dtypes against the
target tree first and raises one ``ValueError`` listing every mismatch.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Any

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in the tree's own order (dict keys sorted)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree, key=str)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix or "_root": tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{_SAFE.sub('_', k)}" if prefix
                            else _SAFE.sub("_", k)))
    return out


def _unflatten(like: Tree, leaves: Dict[str, Any], prefix: str = "") -> Tree:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{_SAFE.sub('_', str(k))}"
                              if prefix else _SAFE.sub("_", str(k)))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(like)]
        return type(like)(vals)
    return leaves[prefix or "_root"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype to save")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return np.dtype(str(x.dtype).removeprefix("torch."))
    return np.asarray(x).dtype


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
         extra: Optional[dict] = None) -> str:
    """Save ``tree`` as step ``step`` of ``ckpt_dir``; returns the step's
    directory.  ``extra`` (JSON-serialisable) rides in the manifest."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    arrays = {k: _host(v) for k, v in _flatten(tree).items()}

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
        if shape != tuple(ref.shape):
            problems.append(f"{k}: shape {shape} != expected "
                            f"{tuple(ref.shape)}")
        if dtype != _dtype(ref):
            problems.append(f"{k}: dtype {dtype} != expected {_dtype(ref)}")
    if problems:
        raise ValueError(f"checkpoint {where} does not match the restore "
                         f"target:\n  " + "\n  ".join(problems))


def restore(ckpt_dir: str, like: Tree, step: Optional[int] = None) -> Tree:
    """Restore step ``step`` (default: LATEST) into the structure of
    ``like``: a tensor leaf comes back as a tensor on that leaf's device, a
    numpy leaf as a numpy array.  Raises ``ValueError`` if the manifest
    disagrees with ``like`` on keys, shapes or dtypes."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat_like = _flatten(like)
    _validate(read_manifest(ckpt_dir, step), flat_like, d)
    leaves = {}
    with np.load(os.path.join(d, "arrays.npz"), allow_pickle=False) as data:
        for key, ref in flat_like.items():
            a = data[key]
            leaves[key] = (torch.from_numpy(a).to(ref.device)
                           if isinstance(ref, torch.Tensor) else a)
    return _unflatten(like, leaves)
