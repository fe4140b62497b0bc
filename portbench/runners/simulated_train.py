"""Runner ``simulated_train``: the port's training step on one device,
``repro_torch.core.dist.make_train_step``, with W workers simulated as the
step's leading axis and the Artemis wire between them (``wire`` in the
traffic), or the plain step (``wire`` null).

A run:

1. set-up: the model (``repro_torch.models.model.build_model``), the
   weights made on the device from the seed (``portbench/weights.py``),
   a pool of batches (``portbench/traffic/generator.py``), the step with
   the program's own noise (``MeshNoise`` seeded with the run's seed);
   the step is driven through its first ``CHECKED_STEPS`` steps on
   batches 0, 1, 2, reading what the check compares from its state; the
   same state goes on into the window;
2. the window: the step back to back over the pool of ``POOL`` batches
   for ``--seconds``, the peak memory counted from its start, set-up's
   garbage collected before it; with ``--trace 1``, after it, one step and
   then a stretch of ``TRACE_SHARE`` of the window under the profiler;
3. after the window, the program's state freed: the plain reference
   (``portbench/reference/train.py`` over the configuration's reference
   module, ``portbench.reference.for_config``) takes the same weights and
   batches and the comparison (``portbench/check.py``) decides
   ``correct``.

Any family whose configuration names a reference module runs here: the
module gives the parameters, the loss and the FLOPs; the workers, the
wire, Adam, the window, the trace and the check are this runner's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import torch

from portbench import check
from portbench import trace as TR
from portbench.bench import Cell, Run, metric_reader
from portbench.reference import for_config
from portbench.reference import train as RT
from portbench.traffic import generator as G
from portbench.weights import make_weights

CHIPS = (1,)              # the chip counts this runner runs on
GIB = float(1 << 30)
POOL = 4                  # batches made in set-up, cycled by the window
CHECKED_STEPS = 3         # the steps the check compares (the limits' own)
TRACE_SHARE = 0.25        # the traced stretch, a share of the window


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: its keys
    that are the dataclass's fields."""
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items() if k in names})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_step(cell: Cell, seed: int, dev: torch.device):
    """``(init_state, step_fn)`` of the program, its gradient function and
    optimizer wrapped in the trace's ranges."""
    from repro_torch.core import dist
    from repro_torch.models.model import build_model
    from repro_torch.optim import Optimizer, adam
    tr = cell.traffic
    model = build_model(program_config(cell.config))
    o = tr["optimizer"]
    base = adam(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"])

    def update(grads, state, step, params=None):
        with TR.span(TR.OPTIM):
            return base.update(grads, state, step, params)

    opt = Optimizer(base.init, update)
    wire = tr.get("wire")
    if not wire:
        return dist.make_train_step(model, opt, None, 1, dev)
    dcfg = dist.DistConfig(
        variant=wire["variant"], s=wire["s"], p_participation=wire["p"],
        seed=seed, bucket_bytes=wire["bucket_bytes"],
        max_buckets=wire["max_buckets"], bucket_row=wire["row"],
        reduce_impl=wire["reduce_impl"])
    inner = dist.vmap_grads(model)

    def grad_fn(params, split):
        with TR.span(TR.GRADS):
            return inner(params, split)

    return dist.make_train_step(model, opt, dcfg, tr["workers"], dev,
                                grad_fn=grad_fn)


def inputs(cell: Cell, seed: int, dev: torch.device, count: int):
    """The run's weights and its first ``count`` batches."""
    spec = for_config(cell.config, cell.root).param_spec(cell.config)
    return (make_weights(spec, seed, dev),
            G.make_batches(cell.traffic, cell.config, seed, dev, count))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def checked_steps(step_fn, state, weights, batches, b1: float):
    """Drive the step through ``len(batches)`` steps; the readings the
    check compares, from the program's state."""
    out: Dict[str, list] = {"losses": []}
    for k, batch in enumerate(batches):
        state, (loss, _) = step_fn(state, batch)
        out["losses"].append(float(loss))
        if k == 0:
            out["grad_norms"] = [_norm(m) / (1.0 - b1)
                                 for m in state.opt_state["m"]]
    out["change_norms"] = [_norm(state.params[k] - w)
                           for k, w in weights.items()]
    art = state.artemis
    if isinstance(art.h, torch.Tensor) and art.h.dim() > 1:   # the wire's
        out["h_norms"] = [_norm(h) for h in art.h]
        out["hbar_norm"] = _norm(art.hbar)
    return state, out


def program_readings(cell: Cell, seed: int, dev: torch.device) -> dict:
    """The program's checked steps alone (the readings tool)."""
    weights, batches = inputs(cell, seed, dev, CHECKED_STEPS)
    init_state, step_fn = build_step(cell, seed, dev)
    _, out = checked_steps(step_fn, init_state(weights), weights, batches,
                           cell.traffic["optimizer"]["b1"])
    return out


@contextlib.contextmanager
def float32_products(ref):
    """TF32 off for the reference module ``ref``, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    ref.no_tf32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def reference_readings(cell: Cell, seed: int, dev: torch.device,
                       precision: str = "f32",
                       fault: Optional[str] = None) -> dict:
    """The plain reference's readings over the checked steps, from the
    run's weights and batches made again."""
    weights, batches = inputs(cell, seed, dev, CHECKED_STEPS)
    ref = for_config(cell.config, cell.root)
    with float32_products(ref):
        return RT.train(cell.config, cell.traffic, weights, batches, seed,
                        precision=precision, fault=fault, model=ref)


def window(step_fn, state, pool: List[dict], first: int, seconds: float,
           dev: torch.device):
    """The step back to back over the pool from batch ``first`` until
    ``seconds`` have passed; (state, steps, seconds), the device drained
    at both ends."""
    _sync(dev)
    t = time.perf_counter()
    n = 0
    while True:
        state, _ = step_fn(state, pool[(first + n) % len(pool)])
        n += 1
        if time.perf_counter() - t >= seconds:
            break
    _sync(dev)
    return state, n, time.perf_counter() - t


def trace_context(cell: Cell, steps: int, window_s: float) -> dict:
    """What the readers need beside the trace, the untraced window's steps
    and seconds (``paced``) among it."""
    tr, cfg = cell.traffic, cell.config
    ref = for_config(cfg, cell.root)
    ctx = {"flops_per_step": ref.step_flops(
        cfg, tr["rows"], tr["seq"], tr.get("frames", 0)), "wire": None,
        "paced": {"steps": steps, "seconds": window_s}}
    if tr.get("wire"):
        w = tr["wire"]
        total = ref.param_count(ref.param_spec(cfg))
        ctx["wire"] = {"workers": tr["workers"], "shape": RT.layout(
            total, w["bucket_bytes"], w["max_buckets"], w["row"])}
    return ctx


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak}


def _peak(dev: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)


def run(r: Run) -> dict:
    cell, dev, tr = r.cell, r.device, r.cell.traffic
    weights, pool = inputs(cell, r.seed, dev, POOL)
    init_state, step_fn = build_step(cell, r.seed, dev)
    state, prog = checked_steps(step_fn, init_state(weights), weights,
                                pool[:CHECKED_STEPS], tr["optimizer"]["b1"])
    del weights
    # set-up's garbage goes now, not at some collection inside the window;
    # the allocator keeps its cache, so that the window's first steps do
    # not allocate again (and, near the card's capacity, retry)
    gc.collect()
    setup_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - r.t0

    # the window's only reference to the state: each step's state is
    # freed as the next one takes its place; the pool's batches in turn
    held: Dict = {"state": state, "next": CHECKED_STEPS}
    del state

    def measured(seconds: float):
        held["state"], steps, secs = window(step_fn, held.pop("state"),
                                            pool, held["next"], seconds, dev)
        held["next"] += steps
        return steps, secs

    steps, window_s = measured(r.seconds)
    trace: Optional[TR.Trace] = None
    if r.trace:
        trace = TR.traced(lambda: measured(r.seconds * TRACE_SHARE),
                          lambda: measured(0.0),
                          trace_context(cell, steps, window_s))
    window_peak = _peak(dev)
    del held, step_fn, init_state, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(cell, r.seed, dev)
    correct, checks = check.judge(check.gaps(prog, ref), cell.limits)

    if trace is None:
        # positions a second: tokens, and frames where the model has an
        # encoder; a cell reports the name its end_to_end lists
        rate = steps * G.positions(tr, cell.config) / window_s
        values = {
            "train_tok_per_s": rate, "train_pos_per_s": rate,
            "peak_mem_gib": window_peak / GIB,
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = device_info(dev, max(setup_peak, window_peak))
    out = {"correct": correct, "attempted": steps, "failed": 0,
           "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        out["breakdown"] = TR.breakdown(trace)
    out["checks"] = checks
    return out

