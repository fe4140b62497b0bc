"""The one-card dry run (port of ``repro/launch/dryrun.py``): every
(arch x input shape) step at full width, traced on fake tensors, without
allocating memory, against the roofline of one H100.

For each combo that ``configs.applicable`` admits, the model is built and
its step run under ``FakeTensorMode`` (tensors with shapes and dtypes and
no storage, on the CPU, so the kernels' wrappers take their plain
versions): the train step (``dist.make_train_step``: ``--dist none``, the
plain data-parallel step, or a variant at W simulated workers), the
prefill (``prefill_logits``) or one decode step against a cache of the
shape's length (``configs.input_specs``).  It records

  * the FLOPs (``torch.utils.flop_counter.FlopCounterMode``: the matrix
    products, convolutions and attention; elementwise work is not counted);
  * the parameter, optimizer-state and Artemis-memory bytes;
  * an estimate of peak bytes: ``LiveBytes`` tracks every live storage
    (parameters, state, batch, each op's outputs, and what autograd saves)
    and frees it when its last reference goes;
  * the bytes the ops read and write, each op's inputs and outputs once
    (views move nothing): eager PyTorch's traffic with nothing fused;
  * the roofline terms against one H100 (``launch/roofline.py``): compute
    (FLOPs at the dense bf16 peak), memory (those bytes at the memory
    rate), and the wire (the ring's bytes, were the W workers W cards on
    NVLink; 0 without a wire).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-7b \\
      --shape train_4k --dist artemis --workers 8 [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

With ``--mesh pod|multipod`` (``lower_mesh``) the combo runs on the
production mesh of ``launch/mesh.py`` instead, (16, 16) or (2, 16, 16),
as rank 0 of a fake process group of 256 or 512 ranks (so each such combo
needs a process of its own; ``--mesh both`` runs the two in
subprocesses): parameters, state, batch and cache are DTensors at the
policy's sharding, the model's hooks are set and the MoE anchors on.  A
dispatch mode sees a DTensor op at its global shape, so ``RankCounter``
lets DTensor run each op as this rank's collectives and local ops and
counts those: the rank's parameter, optimizer and Artemis bytes, its
peak estimate, FLOPs and bytes accessed, and its collective bytes by op
and mesh axis (``CommDebugMode`` counts the collectives), priced by
``Roofline.collective_s``.  The train step is ``dist_pg``'s mesh step:
``--dist none`` plain data parallelism, a variant Artemis over the
worker axis (``pod``, or ``data`` on one pod) with the full gradient on
the wire.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-7b \\
      --shape train_4k --mesh multipod --dist artemis

``--all`` runs each combo in a subprocess (``--jobs`` at a time), as the
reference does: the one-card rows (train also with artemis), then the
reference's mesh matrix, ``pod`` for every (arch, shape) and ``multipod``
with artemis for the train shapes (the 3-D mesh's ``--dist none`` rows
are left to ``--mesh multipod``: DTensor plans each for minutes).
``--batch`` and ``--seq`` override the shape's, ``--reduced`` takes the
arch's reduced config, and ``lm-20m`` and ``lm-100m`` are
``experiments.lm_config``'s models.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.core import dist
from repro_torch.launch import roofline as R
from repro_torch.models import layers as L
from repro_torch.models.model import build_model, flatten_params
from repro_torch.optim import adam, sgd

H100_BYTES = 80e9           # device memory of one H100 SXM
LM_CONFIGS = {"lm-20m": False, "lm-100m": True}   # full_100m


def _locals(tree):
    """The tensors of a tree, each DTensor as its local block."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of every live storage (``track`` adds existing
    tensors; each op's outputs are added as they appear) and their peak,
    and the bytes each op reads and writes (``accessed``)."""

    def __init__(self):
        super().__init__()
        self._sizes: Dict[int, int] = {}
        self.live = self.peak = self.accessed = 0

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, tree) -> None:
        for t in _locals(tree):
            s = t.untyped_storage()
            key = s._cdata
            if key not in self._sizes:
                self._sizes[key] = s.nbytes()
                self.live += self._sizes[key]
                weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.accessed += sum(
                t.numel() * t.element_size()
                for t in tree_flatten((args, kwargs, out))[0]
                if isinstance(t, torch.Tensor))
        self.track(out)
        return out


_COLLECTIVE_OPS = {
    # functional collectives (what DTensor issues): the result's bytes
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    # the process-group ring and the loss's mean (c10d's own ops)
    "c10d.send": "send",
    "c10d.allreduce_": "all-reduce",
}


class RankCounter(LiveBytes):
    """``LiveBytes`` for one rank of a DTensor mesh, with its FLOPs and its
    collectives' bytes by op and by mesh axis.  A dispatch mode sees a
    DTensor op at its global shape, so an op with a DTensor among its
    types is handed back (``NotImplemented``): DTensor runs it as the
    collectives and local ops of this rank, which come here on local
    tensors and are counted.  ``comm`` (a
    ``torch.distributed.tensor.debug.CommDebugMode``) counts the same
    collectives by op.  A collective counts under the axis of ``mesh``
    whose group it is, or whose row of ranks holds all of its group's (a
    sub-group of an axis, as the attention's runs of model ranks), else
    under "other"; bytes are each collective's result on this rank (a
    send's payload)."""

    def __init__(self, mesh):
        super().__init__()
        import torch.distributed as tdist
        from torch.distributed.tensor.debug import CommDebugMode
        names = mesh.mesh_dim_names
        self.axes = {mesh.get_group(a).group_name: a for a in names}
        self.rows = {a: set(tdist.get_process_group_ranks(mesh.get_group(a)))
                     for a in names}
        self.flops = 0.0
        self.coll: Dict[str, Dict[str, float]] = {}
        self.comm = CommDebugMode()

    def __enter__(self):
        self.comm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.comm.__exit__(*exc)
        return out

    def _axis(self, args) -> str:
        """The mesh axis of a collective's group: a functional collective
        names it, a c10d op carries it boxed."""
        import torch.distributed as tdist
        unbox = getattr(tdist.ProcessGroup, "unbox", None)
        for a in tree_flatten(args)[0]:
            if isinstance(a, torch.ScriptObject) and unbox is not None:
                a = unbox(a)
            name = a if isinstance(a, str) else getattr(a, "group_name",
                                                        None)
            if name is not None and name not in self.axes:
                self.axes[name] = self._row_of(name)
            if self.axes.get(name):
                return self.axes[name]
        return "other"

    def _row_of(self, name: str) -> Optional[str]:
        """The axis whose row holds every rank of the group named
        ``name`` (more than one rank: a lone rank lies in every row);
        ``None`` for a group of no row, or a name of no group."""
        import torch.distributed as tdist
        from torch.distributed.distributed_c10d import _resolve_process_group
        try:
            ranks = set(tdist.get_process_group_ranks(
                _resolve_process_group(name)))
        except RuntimeError:            # an argument that names no group
            return None
        return next((a for a, row in self.rows.items()
                     if len(ranks) > 1 and ranks <= row), None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](
                *args, **(kwargs or {}), out_val=out))
        op = _COLLECTIVE_OPS.get(str(packet))
        if op is not None:
            what = args if op == "send" else out
            moved = sum(t.numel() * t.element_size()
                        for t in tree_flatten(what)[0]
                        if isinstance(t, torch.Tensor))
            by_op = self.coll.setdefault(self._axis(args), {})
            by_op[op] = by_op.get(op, 0.0) + float(moved)
        return out


def _nbytes(tree) -> int:
    """Bytes of the tensors of a tree of dicts, sequences and
    dataclasses (a DTensor's: this rank's block)."""
    return sum(t.numel() * t.element_size()
               for t in _locals(list(flatten_params(tree).values())))


def _config(arch: str, reduced: bool, overrides: Optional[dict]):
    if arch in LM_CONFIGS:
        from repro_torch.experiments import lm_config
        cfg = lm_config(LM_CONFIGS[arch])
    else:
        cfg = configs.get_config(arch, reduced=reduced)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _shape(name: str, batch: Optional[int], seq: Optional[int]):
    shape = configs.SHAPES[name]
    if batch is not None:
        shape = dataclasses.replace(shape, batch=batch)
    if seq is not None:
        shape = dataclasses.replace(shape, seq=seq)
    return shape


def _fake(spec):
    """A meta spec as a fake CPU tensor of the same shape and dtype."""
    return torch.empty(spec.shape, dtype=spec.dtype)


def _wire_s(dcfg, params, workers: int) -> float:
    """The ring's time, were the W workers W cards on NVLink."""
    if dcfg is None or not dcfg.up_compress:
        return 0.0
    shapes = [tuple(p.shape) for p in params.values()]
    if dcfg.bucketed:
        lay = dcfg.layout(shapes)
        return R.bucketed_wire_model(
            n_workers=workers, n_buckets=lay.n_buckets, rows=lay.rows,
            row=lay.row)["comm_s"]
    return R.leaf_wire_model(shapes, n_workers=workers)["comm_s"]


def lower_one(arch: str, shape_name: str, dist_variant: str = "none", *,
              workers: int = 8, batch: Optional[int] = None,
              seq: Optional[int] = None, reduced: bool = False,
              optimizer: str = "sgd", cfg_overrides: Optional[dict] = None,
              dist_overrides: Optional[dict] = None) -> dict:
    """Trace one combo on fake tensors; returns its record (``status``
    ok or skip)."""
    cfg = _config(arch, reduced, cfg_overrides)
    shape = _shape(shape_name, batch, seq)
    rec = {"arch": arch, "shape": shape_name, "batch": shape.batch,
           "seq": shape.seq, "kind": shape.kind, "mesh": "one-card",
           "dist": dist_variant if shape.kind == "train" else "none",
           "workers": workers if shape.kind == "train"
           and dist_variant != "none" else 1}
    skip = configs.applicable(cfg, shape)
    if skip:
        return {**rec, "status": "skip", "reason": skip}
    model = build_model(cfg)
    t0 = time.time()
    with FakeTensorMode():
        params = model.init(torch.Generator())
        specs = tree_map(_fake, configs.input_specs(cfg, shape, model))
        flops = FlopCounterMode(display=False)
        live = LiveBytes()
        state, dcfg = {}, None
        with flops, live:
            live.track((params, specs))
            if shape.kind == "train":
                opt = (adam if optimizer == "adam" else sgd)(1e-2)
                dcfg = (None if dist_variant == "none" else dist.DistConfig(
                    variant=dist_variant, **(dist_overrides or {})))
                init_state, step_fn = dist.make_train_step(
                    model, opt, dcfg, workers, device="cpu")
                st = init_state(params)
                state = {"optimizer": _nbytes(st.opt_state),
                         "artemis": _nbytes(st.artemis)}
                step_fn(st, specs)
            elif shape.kind == "prefill":
                model.prefill_logits(params, specs)
            else:
                model.decode_step(params, specs["cache"], specs["token"],
                                  shape.seq - 1,
                                  enc_out=specs.get("enc_out"))
        n_flops = float(flops.get_total_flops())
        param_bytes = _nbytes(params)
        rl = R.Roofline(
            arch=arch, shape=shape_name, kind=shape.kind, flops=n_flops,
            bytes_accessed=float(live.accessed),
            wire_s=_wire_s(dcfg, params, workers),
            model_flops=R.model_flops(cfg, params, shape.kind, shape.batch,
                                      shape.seq)).finalize()
    return {**rec, "status": "ok", "trace_s": round(time.time() - t0, 2),
            "param_bytes": param_bytes,
            "optimizer_bytes": state.get("optimizer", 0),
            "artemis_bytes": state.get("artemis", 0),
            "peak_bytes": live.peak,
            "fits_h100": live.peak < H100_BYTES, **rl.as_dict()}


MESH_RANKS = {"pod": 256, "multipod": 512}


def _fake_group(world: int) -> None:
    """This process's default group: ``world`` ranks of torch's fake
    process group, this process rank 0 (collectives move nothing)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if tdist.get_world_size() == world:
            return
        tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)


def lower_mesh(arch: str, shape_name: str, mesh_kind: str,
               dist_variant: str = "none", *, batch: Optional[int] = None,
               seq: Optional[int] = None, reduced: bool = False,
               optimizer: str = "sgd", cfg_overrides: Optional[dict] = None,
               dist_overrides: Optional[dict] = None) -> dict:
    """One combo on the production mesh (``pod``: (16, 16), ``multipod``:
    (2, 16, 16)) as rank 0 of a fake process group of 256 or 512 ranks,
    which becomes this process's default group: run it in a process of
    its own.  Parameters, state, batch and cache are DTensors at the
    policy's sharding (``launch/mesh.py``), the model's hooks are set and
    the MoE anchors on, as the reference's dry run has them.  The train
    step is ``dist_pg.make_train_step(mesh=)``: plain data parallelism
    with ``--dist none``, else Artemis over the worker axis (``pod`` on
    the multi-pod mesh, ``data`` on one pod).  Every count is this rank's
    (``RankCounter``); ``attn_blocks`` lists the attention blocks it ran
    (query heads, KV heads, head-dim lanes; ``layers.recording_blocks``)."""
    from repro_torch.core import dist_pg
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MOE
    cfg = _config(arch, reduced, cfg_overrides)
    shape = _shape(shape_name, batch, seq)
    dv = dist_variant if shape.kind == "train" else "none"
    rec = {"arch": arch, "shape": shape_name, "batch": shape.batch,
           "seq": shape.seq, "kind": shape.kind, "mesh": mesh_kind,
           "chips": MESH_RANKS[mesh_kind], "dist": dv}
    skip = configs.applicable(cfg, shape)
    if skip:
        return {**rec, "status": "skip", "reason": skip}
    _fake_group(MESH_RANKS[mesh_kind])
    mesh = M.make_production_mesh(multi_pod=mesh_kind == "multipod",
                                  device_type="cpu")
    model = build_model(cfg)
    MOE.set_moe_sharding(cfg.family == "moe")
    dcfg = None
    if dv != "none":
        waxes = ("pod",) if mesh_kind == "multipod" else ("data",)
        dcfg = dist.DistConfig(worker_axes=waxes, variant=dv,
                               **(dist_overrides or {}))
    banned = dcfg.worker_axes if dcfg else ()
    model.set_sharding(M.layer_constraint_fn(mesh, banned),
                       M.act_constraint_fn(mesh, banned))
    t0 = time.time()
    try:
        # the mesh's own bookkeeping (sub-mesh rank maps) holds real tensors
        with FakeTensorMode(allow_non_fake_inputs=True), \
                _real_index_maths():
            full = model.init(torch.Generator())
            pshard = M.params_shardings(mesh, full)
            params = {k: M.distribute(v, pshard[k]) for k, v in full.items()}
            del full
            specs = tree_map(_fake, configs.input_specs(cfg, shape, model))
            counter, state = RankCounter(mesh), {}
            with counter, L.recording_blocks() as blocks:
                if shape.kind == "train":
                    data = {k: M.distribute(v, sh) for (k, v), sh in zip(
                        specs.items(),
                        M.batch_shardings(mesh, specs).values())}
                    counter.track((params, data))
                    opt = (adam if optimizer == "adam" else sgd)(1e-2)
                    init_state, step_fn = dist_pg.make_train_step(
                        model, opt, dcfg, device="cpu", mesh=mesh)
                    st = init_state(params)
                    counter.track(st)
                    state = {"optimizer": _nbytes(st.opt_state),
                             "artemis": _nbytes(st.artemis)}
                    step_fn(st, data)
                elif shape.kind == "prefill":
                    data = {k: M.distribute(v, sh) for (k, v), sh in zip(
                        specs.items(),
                        M.batch_shardings(mesh, specs).values())}
                    counter.track((params, data))
                    with _replicated():
                        model.prefill_logits(params, data)
                else:
                    placed = _place_decode(mesh, specs)
                    counter.track((params, placed))
                    with _replicated():
                        model.decode_step(params, placed["cache"],
                                          placed["token"], shape.seq - 1,
                                          enc_out=placed.get("enc_out"))
            param_bytes = _nbytes(params)
            rl = R.Roofline(
                arch=arch, shape=shape_name, kind=shape.kind,
                flops=counter.flops, bytes_accessed=float(counter.accessed),
                wire_s=0.0, coll_bytes=counter.coll,
                model_flops=R.model_flops(cfg, params, shape.kind,
                                          shape.batch, shape.seq)
                / MESH_RANKS[mesh_kind]).finalize()
    finally:
        MOE.set_moe_sharding(False)
    counts = {str(k): int(v)
              for k, v in counter.comm.get_comm_counts().items()}
    return {**rec, "status": "ok", "trace_s": round(time.time() - t0, 2),
            "param_bytes": param_bytes,
            "optimizer_bytes": state.get("optimizer", 0),
            "artemis_bytes": state.get("artemis", 0),
            "peak_bytes": counter.peak, "fits_h100": counter.peak < H100_BYTES,
            "comm_counts": counts,
            "attn_blocks": [list(b) for b in sorted(set(blocks))],
            **rl.as_dict()}


@contextlib.contextmanager
def _real_index_maths():
    """DTensor's planner finds a strided shard's offsets by indexing a
    ``torch.arange`` and reading it back, which a fake tensor cannot do:
    while entered, that arithmetic runs on real (small) tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    names = ("local_shard_size_and_offset", "_local_shard_size_and_offset")
    saved = {n: _StridedShard.__dict__[n] for n in names
             if n in _StridedShard.__dict__}

    def real(fn):
        def wrapped(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return wrapped

    for n, fn in saved.items():
        setattr(_StridedShard, n, staticmethod(real(fn.__func__))
                if isinstance(fn, staticmethod) else real(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(_StridedShard, n, fn)


def _replicated():
    """Plain tensors made inside the model (positions, masks) meet the
    DTensors as replicated ones."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _place_decode(mesh, specs: dict) -> dict:
    """A decode step's inputs on the mesh: the cache at ``cache_spec``, the
    token over the batch axes, the encoder output as a batch."""
    from repro_torch.launch import mesh as M

    def cache_leaf(t):
        return M.distribute(t, M.NamedSharding(mesh, M.cache_spec(
            mesh, "", tuple(t.shape))))

    out = {"cache": dist.map_tree(cache_leaf, specs["cache"]),
           "token": M.distribute(specs["token"], M.NamedSharding(
               mesh, M.batch_spec(mesh, tuple(specs["token"].shape))))}
    if "enc_out" in specs:
        out["enc_out"] = M.distribute(specs["enc_out"], M.NamedSharding(
            mesh, M.batch_spec(mesh, tuple(specs["enc_out"].shape))))
    return out


def _parse_overrides(items) -> dict:
    """``k=v`` items as a dict: ints, floats, ``True``/``False`` and
    ``None`` as such, anything else a string."""
    out = {}
    words = {"None": None, "True": True, "False": False}
    for it in items or []:
        k, v = it.split("=", 1)
        if v in words:
            out[k] = words[v]
            continue
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def _combos():
    """``--all``: every (arch, shape) on one card (train also with
    artemis), then the reference's mesh matrix: ``pod`` for every (arch,
    shape), ``multipod`` with artemis for the train shapes."""
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            train = configs.SHAPES[shape].kind == "train"
            for dv in ["none", "artemis"] if train else ["none"]:
                yield arch, shape, None, dv
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            yield arch, shape, "pod", "none"
            if configs.SHAPES[shape].kind == "train":
                yield arch, shape, "multipod", "artemis"


def _label(arch, shape, mesh, dv) -> str:
    return " x ".join([arch, shape] + ([mesh] if mesh else []) + [dv])


def run_all(jobs: int, workers: int, timeout: float = 1800.0,
            cfg_override=(), combos=None) -> list:
    """Every combo (``_combos``, or those given as (arch, shape, mesh,
    dist)) in its own subprocess, ``jobs`` at a time, each with the
    ``k=v`` config overrides of ``cfg_override``."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    pending = list(_combos() if combos is None else combos)
    results, running = [], []
    with tempfile.TemporaryDirectory() as tmp:
        while pending or running:
            while pending and len(running) < jobs:
                arch, shape, mesh, dv = pending.pop(0)
                out = os.path.join(tmp, f"{len(results) + len(running)}.json")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--dist", dv,
                       "--workers", str(workers), "--out", out]
                if mesh:
                    cmd += ["--mesh", mesh]
                for it in cfg_override:
                    cmd += ["--cfg-override", it]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True,
                                        env=env)
                running.append(((arch, shape, mesh, dv), out, proc,
                                time.time()))
            done = None
            for item in running:
                if item[2].poll() is not None or (time.time() - item[3]
                                                  > timeout):
                    done = item
                    break
            if done is None:
                time.sleep(0.2)
                continue
            running.remove(done)
            (arch, shape, mesh, dv), out, proc, _ = done
            if proc.poll() is None:
                proc.kill()
            log = proc.communicate()[0] or ""
            try:
                with open(out) as fh:
                    rec = json.load(fh)[0]
            except (OSError, ValueError, IndexError):
                rec = {"arch": arch, "shape": shape,
                       "mesh": mesh or "one-card", "dist": dv,
                       "status": "error", "error": log[-800:]}
            results.append(rec)
            print(f"{_label(arch, shape, mesh, dv)}: {rec['status']}"  # repro-lint: allow=print-in-library (CLI driver)
                  + (f" ({rec['dominant']}, peak "
                     f"{rec['peak_bytes'] / 1e9:.2f} GB)"
                     if rec["status"] == "ok" else ""), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--dist", default="none",
                    help="none|sgd|qsgd|diana|biqsgd|artemis|dore "
                         "(train shapes)")
    ap.add_argument("--workers", type=int, default=8,
                    help="W, the workers simulated on the card (train with "
                         "a wire)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape (train also with artemis), "
                         "each in a subprocess")
    ap.add_argument("--jobs", type=int, default=1,
                    help="subprocesses at a time with --all")
    ap.add_argument("--mesh", default=None,
                    choices=["pod", "multipod", "both"],
                    help="the production mesh, as one rank of a fake "
                         "process group: pod (16 x 16), multipod (2 x 16 x "
                         "16) or both (each in a subprocess); omit for one "
                         "card")
    ap.add_argument("--cfg-override", action="append", default=[])
    ap.add_argument("--dist-override", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        results = run_all(args.jobs, args.workers,
                          cfg_override=args.cfg_override)
    elif not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    elif args.mesh == "both":
        results = run_all(1, args.workers, cfg_override=args.cfg_override,
                          combos=[(args.arch, args.shape, m, args.dist)
                                  for m in ("pod", "multipod")])
    else:
        kw = dict(batch=args.batch, seq=args.seq, reduced=args.reduced,
                  optimizer=args.optimizer,
                  cfg_overrides=_parse_overrides(args.cfg_override),
                  dist_overrides=_parse_overrides(args.dist_override))
        if args.mesh:
            results = [lower_mesh(args.arch, args.shape, args.mesh,
                                  args.dist, **kw)]
        else:
            results = [lower_one(args.arch, args.shape, args.dist,
                                 workers=args.workers, **kw)]
        for r in results:
            print(json.dumps(r))  # repro-lint: allow=print-in-library (CLI driver)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skip", "error")}
    print(f"dryrun: {n['ok']} ok, {n['skip']} skip, {n['error']} error")  # repro-lint: allow=print-in-library (CLI driver)
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
