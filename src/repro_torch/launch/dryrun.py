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

``--all`` runs each combo in a subprocess (``--jobs`` at a time), as the
reference does.  There is no pod or multi-pod mesh on one card: ``--mesh``
is refused (ROADMAP §A).  ``--batch`` and ``--seq`` override the shape's,
``--reduced`` takes the arch's reduced config, and ``lm-20m`` and
``lm-100m`` are ``experiments.lm_config``'s models.
"""
from __future__ import annotations

import argparse
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
from repro_torch.models.model import build_model, flatten_params
from repro_torch.optim import adam, sgd

H100_BYTES = 80e9           # device memory of one H100 SXM
LM_CONFIGS = {"lm-20m": False, "lm-100m": True}   # full_100m


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
        for t in tree_flatten(tree)[0]:
            if not isinstance(t, torch.Tensor):
                continue
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


def _nbytes(tree) -> int:
    """Bytes of the tensors of a tree of dicts, sequences and
    dataclasses."""
    return sum(t.numel() * t.element_size()
               for t in flatten_params(tree).values()
               if isinstance(t, torch.Tensor))


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


def _combos(workers: int):
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            dists = ["none"]
            if configs.SHAPES[shape].kind == "train":
                dists.append("artemis")
            for dv in dists:
                yield arch, shape, dv


def run_all(jobs: int, workers: int, timeout: float = 1800.0,
            cfg_override=()) -> list:
    """Every combo in its own subprocess, ``jobs`` at a time, each with the
    ``k=v`` config overrides of ``cfg_override``."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    pending = list(_combos(workers))
    results, running = [], []
    with tempfile.TemporaryDirectory() as tmp:
        while pending or running:
            while pending and len(running) < jobs:
                arch, shape, dv = pending.pop(0)
                out = os.path.join(tmp, f"{len(results) + len(running)}.json")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--dist", dv,
                       "--workers", str(workers), "--out", out]
                for it in cfg_override:
                    cmd += ["--cfg-override", it]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True,
                                        env=env)
                running.append(((arch, shape, dv), out, proc, time.time()))
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
            (arch, shape, dv), out, proc, _ = done
            if proc.poll() is None:
                proc.kill()
            log = proc.communicate()[0] or ""
            try:
                with open(out) as fh:
                    rec = json.load(fh)[0]
            except (OSError, ValueError, IndexError):
                rec = {"arch": arch, "shape": shape, "dist": dv,
                       "status": "error", "error": log[-800:]}
            results.append(rec)
            print(f"{arch} x {shape} x {dv}: {rec['status']}"  # repro-lint: allow=print-in-library (CLI driver)
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
                    help="refused: the port has no pod or multi-pod mesh")
    ap.add_argument("--cfg-override", action="append", default=[])
    ap.add_argument("--dist-override", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.mesh is not None:
        ap.error("--mesh: the one-card dry run has no pod or multi-pod mesh; "
                 "the sharded mesh (launch/mesh.py) and the multi-pod dry "
                 "run are queued in ROADMAP.md §A")
    if args.all:
        results = run_all(args.jobs, args.workers,
                          cfg_override=args.cfg_override)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        results = [lower_one(
            args.arch, args.shape, args.dist, workers=args.workers,
            batch=args.batch, seq=args.seq, reduced=args.reduced,
            optimizer=args.optimizer,
            cfg_overrides=_parse_overrides(args.cfg_override),
            dist_overrides=_parse_overrides(args.dist_override))]
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
