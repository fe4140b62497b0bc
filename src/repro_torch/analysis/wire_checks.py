"""What crosses the port's wire, counted from the tensors themselves
(stands for ``repro/analysis/hlo_checks.py``, which reads the same facts
off the compiled HLO).

Rules:

  uncompressed-wire      error  for a registered codec (``core/codec.py``
                                registry) on a wire (bucketed, leaf), the
                                payload that crosses the simulated ring, or
                                that ``core/dist_pg.py``'s ranks hand to
                                the process group's sends, does not carry
                                exactly the codec's declared dtypes, or its
                                bytes per dtype differ from the wire model
                                (``launch/roofline.py``): something
                                decompressed the payload before the wire.
  f32-allreduce-payload  error  an f32 all-reduce of a payload's size (a
                                psum of decoded gradients) runs on a
                                compressed wire, simulated or on the
                                process group; metric scalars pass.
  host-sync              error  on the card only: a synchronization of the
                                host with the device inside one clean sweep
                                round or one bucketed mesh step, under
                                ``torch.cuda.set_sync_debug_mode("error")``,
                                listed with its file and line.
  local-step-sends       error  a local step of ``core/dist_pg.py``
                                (``local_steps > 1``, the accumulate-only
                                step between communicating ones) sends or
                                all-reduces anything over the process
                                group (the reference's local step has no
                                collective in its HLO).
  missing-donation       error  the ring's accumulator changes its storage
                                across the in-place hops of
                                ``bucket_acc_hop_`` (the port's one
                                in-place carry).  The sweep's carries are
                                rebuilt each round (``w = w - g * omega``:
                                new tensors, the old freed by the
                                allocator), so for them the rule has no
                                counterpart.
  wire-entry-error       error  a check raised.

The simulated ring is counted through ``CountingAxis``, the simulated
worker axis with a tally of every tensor handed to a ring hop or an
all-reduce; the process group through counting wrappers around
``torch.distributed``'s sends and all-reduces inside its ranks.  Bytes are
per worker per step, keyed (op, dtype) with the reference's HLO dtype
names (``s8``, ``f32``, ``s32``).
"""
from __future__ import annotations

import json
import os
import tempfile
import traceback
import warnings
from typing import Dict, List, Sequence, Tuple
from unittest import mock

import torch

from repro_torch import default_device
from repro_torch.analysis.findings import Finding
from repro_torch.core import codec as wire
from repro_torch.core import dist as D
from repro_torch.launch import roofline

RULES = {
    "uncompressed-wire": "error",
    "f32-allreduce-payload": "error",
    "host-sync": "error",
    "local-step-sends": "error",
    "missing-donation": "error",
    "wire-entry-error": "error",
}

DTYPE_NAMES = {torch.int8: "s8", torch.uint8: "u8", torch.int32: "s32",
               torch.int64: "s64", torch.float32: "f32",
               torch.bfloat16: "bf16", torch.float16: "f16"}

Tally = Dict[Tuple[str, str], float]
RING, ALL_REDUCE = "ring", "all-reduce"


def _add(tally: Tally, op: str, t: torch.Tensor, times: float) -> None:
    key = (op, DTYPE_NAMES[t.dtype])
    tally[key] = tally.get(key, 0.0) + times * t.numel() * t.element_size()


class CountingAxis(D.SimulatedAxis):
    """The simulated worker axis, tallying the bytes one worker puts on the
    wire: a ring's payload leaves ``[W, ...]`` over its W - 1 hops, an
    all-reduce's tensor once."""

    def __init__(self, n_workers: int, reduce_impl: str = "pipelined"):
        super().__init__(n_workers, reduce_impl)
        self.tally: Tally = {}

    def _payload(self, payload: wire.WirePayload, psum: bool) -> None:
        op, hops = (ALL_REDUCE, 1) if psum else (RING, self.n - 1)
        for t in payload.leaves():
            _add(self.tally, op, t[0], hops)

    def ring(self, codec, payload):
        self._payload(payload, self.reduce_impl == "psum")
        return super().ring(codec, payload)

    def leaf_ring(self, codec, payload):
        self._payload(payload, False)
        return super().leaf_ring(codec, payload)

    def dense(self, x):
        _add(self.tally, ALL_REDUCE, x[0], 1)
        return super().dense(x)


def _shapes(dcfg: D.DistConfig, params: Sequence[Tuple[int, ...]]):
    return (dcfg.layout(params).shape if dcfg.bucketed
            else [tuple(s) for s in params])


def measure_wire(dcfg: D.DistConfig, params: Sequence[Tuple[int, ...]],
                 n_workers: int, device=None) -> Tally:
    """One aggregate of ``dcfg`` over parameter leaves of the given shapes,
    with random gradients on ``device``: the bytes by (op, dtype) that one
    worker put on the simulated wire."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = _shapes(dcfg, params)
    state = D.init_dist_state(dcfg, params, n_workers, device=dev)
    draws = D.MeshNoise(dcfg.seed, n_workers, shapes, dev).step(0)
    axis = CountingAxis(n_workers, dcfg.reduce_impl)
    if dcfg.bucketed:
        g = torch.randn((n_workers,) + tuple(shapes), generator=gen,
                        device=dev)
        D.bucketed_aggregate(dcfg, state, g, dcfg.layout(params), axis,
                             draws)
    else:
        g = [torch.randn((n_workers,) + s, generator=gen, device=dev)
             for s in shapes]
        D.leaf_aggregate(dcfg, state, g, axis, draws)
    return axis.tally


def model_bytes(dcfg: D.DistConfig, params: Sequence[Tuple[int, ...]],
                n_workers: int) -> Tally:
    """The wire model's bytes by dtype for the same step (the uplink ring:
    ``bucketed_wire_model`` or ``leaf_wire_model`` with each leaf's own
    codec)."""
    hops = n_workers - 1
    if dcfg.bucketed:
        lay = dcfg.layout(params)
        m = roofline.bucketed_wire_model(
            n_workers=n_workers, n_buckets=lay.n_buckets, rows=lay.rows,
            row=lay.row, codec=dcfg.wire_codec(lay.row))
        return {(RING, dt): hops * b for dt, b in m["bytes_by_dtype"].items()
                if b > 0}
    out: Tally = {}
    for s in params:
        msg = tuple(s) if len(s) else (1,)
        m = roofline.leaf_wire_model([msg], n_workers=n_workers,
                                     codec=dcfg.wire_codec(D.leaf_row(s)))
        for dt, b in m["bytes_by_dtype"].items():
            if b > 0:
                out[(RING, dt)] = out.get((RING, dt), 0.0) + b
    return out


def wire_findings(measured: Tally, declared: Tally, entry: str, *,
                  payload_f32_bytes: float) -> List[Finding]:
    """The ring's bytes by dtype against the model's, exactly; and no f32
    all-reduce of a payload's size where the codec compresses."""
    findings: List[Finding] = []
    ring = {dt: b for (op, dt), b in measured.items() if op == RING}
    want = {dt: b for (op, dt), b in declared.items() if op == RING}
    if ring != want:
        findings.append(Finding(
            rule="uncompressed-wire", severity="error", path=entry, line=0,
            message=f"the ring carried {ring} bytes by dtype a worker a "
                    f"step where the codec and the wire model declare "
                    f"{want}: the payload crossed the wire in another form"))
    compressed = any(dt != "f32" for dt in want)
    ar = measured.get((ALL_REDUCE, "f32"), 0.0)
    if compressed and ar >= payload_f32_bytes:
        findings.append(Finding(
            rule="f32-allreduce-payload", severity="error", path=entry,
            line=0,
            message=f"an f32 all-reduce moves {ar:.0f} bytes >= one "
                    f"uncompressed payload ({payload_f32_bytes:.0f}): a "
                    f"dense sum bypasses the compressed ring"))
    return findings


# the checks' model and workers: ToyMLP(2, 32) at W = 4, as the
# reference's matrix
TOY_W = 4


def _toy_params():
    from repro_torch.models.toy import ToyMLP
    return [tuple(p.shape) for p in
            ToyMLP(2, 32).init(torch.Generator().manual_seed(0)).values()]


def audit_codec_wires(device=None) -> List[Finding]:
    """Every registered codec (``none`` is ``identity``'s alias) on both
    wires, the pipelined ring, artemis at s = 3."""
    params = _toy_params()
    n_elems = sum(torch.Size(s).numel() for s in params)
    findings: List[Finding] = []
    for cname in [c for c in wire.available() if c != "none"]:
        for w in D.WIRES:
            entry = f"mesh:{cname}:{w}"
            try:
                dcfg = D.DistConfig(variant="artemis", s=3, wire=w,
                                    codec=cname)
                findings += wire_findings(
                    measure_wire(dcfg, params, TOY_W, device),
                    model_bytes(dcfg, params, TOY_W), entry,
                    payload_f32_bytes=4.0 * n_elems)
            except Exception as e:  # noqa: BLE001 (report, go on)
                findings.append(Finding(
                    rule="wire-entry-error", severity="error", path=entry,
                    line=0, message=f"{type(e).__name__}: {e}"))
    return findings


# ---------------------------------------------------------------------------
# the process-group ring: ranks tally their own sends and all-reduces
# ---------------------------------------------------------------------------

PG_WORLD = 2


def _pg_rank(rank: int, world: int, out_dir: str, device: str) -> None:
    """One rank: a step of each wire, and a local step of each with
    ``local_steps = 2``, with counting wrappers around the group's sends
    and all-reduces; rank 0 writes the tallies."""
    import torch.distributed as tdist
    from repro_torch.core import dist_pg
    from repro_torch.models.toy import ToyMLP
    from repro_torch.optim import sgd

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    tally: Tally = {}
    batch_isend_irecv, all_reduce = tdist.batch_isend_irecv, tdist.all_reduce

    def counting_batch(ops):
        for op in ops:
            if getattr(op.op, "__name__", "") == "isend":
                _add(tally, RING, op.tensor, 1)
        return batch_isend_irecv(ops)

    def counting_all_reduce(t, *args, **kwargs):
        _add(tally, ALL_REDUCE, t, 1)
        return all_reduce(t, *args, **kwargs)

    model = ToyMLP(2, 32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=4)
    out = {}
    with mock.patch.object(tdist, "batch_isend_irecv", counting_batch), \
            mock.patch.object(tdist, "all_reduce", counting_all_reduce):
        for w in D.WIRES:
            dcfg = D.DistConfig(variant="artemis", s=3, wire=w)
            init_state, step_fn = dist_pg.make_train_step(
                model, sgd(0.05), dcfg, device=dev)
            tally.clear()
            step_fn(init_state(params), batch)
            out[w] = {f"{op}/{dt}": b for (op, dt), b in tally.items()}
            local = D.DistConfig(variant="artemis", s=3, wire=w,
                                 local_steps=2)
            init_state, _ = dist_pg.make_train_step(model, sgd(0.05), local,
                                                    device=dev)
            tally.clear()
            dist_pg.make_local_step(model, local)(
                init_state(params), batch)
            out[f"{w}:local"] = {f"{op}/{dt}": b
                                 for (op, dt), b in tally.items()}
    if rank == 0:
        with open(os.path.join(out_dir, "tally.json"), "w") as fh:
            json.dump(out, fh)


def audit_pg_ring(device=None) -> List[Finding]:
    """Two gloo ranks of ``core/dist_pg.py`` on ``device``, one step of each
    wire: the sends against the wire model, the all-reduces against one
    f32 payload; a local step of each: nothing sent."""
    from repro_torch.core import dist_pg
    dev = default_device(device)
    params = _toy_params()
    n_elems = sum(torch.Size(s).numel() for s in params)
    with tempfile.TemporaryDirectory() as tmp:
        codes = dist_pg.launch(_pg_rank, PG_WORLD, (tmp, str(dev.type)),
                               timeout=180.0)
        if codes != [0] * PG_WORLD:
            return [Finding(rule="wire-entry-error", severity="error",
                            path="pg_ring", line=0,
                            message=f"the ranks exited with {codes}")]
        with open(os.path.join(tmp, "tally.json")) as fh:
            got = json.load(fh)
    findings: List[Finding] = []
    for w, tally in got.items():
        if w.endswith(":local"):
            if tally:
                findings.append(Finding(
                    rule="local-step-sends", severity="error",
                    path=f"pg_ring:{w}", line=0,
                    message=f"a local step moved {tally} bytes"))
            continue
        dcfg = D.DistConfig(variant="artemis", s=3, wire=w)
        measured = {tuple(k.split("/")): v for k, v in tally.items()}
        findings += wire_findings(
            measured, model_bytes(dcfg, params, PG_WORLD), f"pg_ring:{w}",
            payload_f32_bytes=4.0 * n_elems)
    return findings


# ---------------------------------------------------------------------------
# host syncs (card only) and the ring's in-place accumulator
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_PORT = os.path.join(_ROOT, "src", "repro_torch") + os.sep
_HERE = os.path.dirname(os.path.abspath(__file__)) + os.sep


SYNC_MESSAGE = "called a synchronizing CUDA operation"


def _sync_site(tb) -> Tuple[str, int, str]:
    """(file, line) of the port's innermost frame (outside this package) in
    the traceback of a sync, and the port's frames that led there."""
    frames = [(os.path.abspath(f.filename), f.lineno, f.name)
              for f in traceback.extract_tb(tb)]
    port = [f for f in frames if f[0].startswith(_PORT)
            and not f[0].startswith(_HERE)]
    chain = " <- ".join(f"{os.path.basename(p)}:{ln} {name}"
                        for p, ln, name in reversed(port[-4:]))
    last = port[-1] if port else frames[-1]
    return os.path.relpath(last[0], _ROOT), last[1], chain


def audit_host_sync(device=None) -> List[Finding]:
    """One clean sweep round and one bucketed mesh step, each after a
    warm-up, under ``torch.cuda.set_sync_debug_mode("error")``: the first
    synchronization of the host with the device in each raises, and is a
    finding at the port's line that issued it.  (The mode is a prototype
    of PyTorch's: it does not see every synchronizing operation.)"""
    from repro_torch.core import artemis as art
    from repro_torch.core import federated as fed
    from repro_torch.core import sweep as sw
    from repro_torch.models.toy import ToyMLP
    from repro_torch.optim import sgd

    dev = default_device(device)
    if dev.type != "cuda":
        raise ValueError("host-sync runs on the card only")
    prob, _ = fed.make_lsr_problem(0, n_workers=8, n_per=20, d=16,
                                   device=dev)
    cfg = art.variant_config("artemis", 16, 8, p=0.7)
    grid = sw._Grid(prob, cfg, torch.full((4,), 0.02, device=dev), 2, 8, 1,
                    False, torch.zeros(16, device=dev),
                    torch.zeros(16, device=dev), False, "cuda")
    noise = sw.TorchNoise([0, 1], 8, 16, 2, 20, dev)
    model = ToyMLP(2, 32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=16)
    init_state, step_fn = D.make_train_step(
        model, sgd(0.05), D.DistConfig(variant="artemis", s=3), 4,
        device=dev)
    state = [init_state(params)]

    def step():
        state[0], _ = step_fn(state[0], batch)

    paths = {"sweep round": lambda: grid.rounds(noise, 1, 2),
             "mesh step": step}
    grid.rounds(noise, 0, 1)
    step()
    torch.cuda.synchronize(dev)
    findings: List[Finding] = []
    for name, fn in paths.items():
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            # the mode's own notice that it is a prototype
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            except RuntimeError as e:
                if SYNC_MESSAGE not in str(e):
                    raise
                path, line, chain = _sync_site(e.__traceback__)
                findings.append(Finding(
                    rule="host-sync", severity="error", path=path,
                    line=line, message=f"the host waits for the device "
                                       f"here in the {name} ({chain})"))
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    return findings


def audit_donation(device=None) -> List[Finding]:
    """The pipelined ring's accumulator keeps its storage across the W
    in-place hops of ``bucket_acc_hop_``."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    w, shape = TOY_W, (2, 3, 64)
    codec = D.DistConfig().wire_codec(shape[-1])
    x = torch.randn((w,) + shape, generator=gen, device=dev)
    payload = codec.encode(x, torch.rand(x.shape, generator=gen, device=dev))
    ptrs = []
    hop_ = D.bucket_acc_hop_

    def watching(acc, q, scales, hop):
        out = hop_(acc, q, scales, hop)
        ptrs.append((acc.data_ptr(), out.data_ptr()))
        return out

    with mock.patch.object(D, "bucket_acc_hop_", watching):
        out = D.bucket_ring_reduce(codec, payload, w)
    if len(ptrs) == w and len({p for pair in ptrs for p in pair}
                              | {out.data_ptr()}) == 1:
        return []
    return [Finding(
        rule="missing-donation", severity="error", path="bucket_ring",
        line=0, message=f"the ring's accumulator moved between hops "
                        f"(data_ptr per hop {ptrs}, result "
                        f"{out.data_ptr()}): the hop is no longer in "
                        f"place")]


def audit_all(device=None) -> List[Finding]:
    """Every check on ``device``; host-sync on the card only."""
    dev = default_device(device)
    checks = [("codec_wires", audit_codec_wires), ("pg_ring", audit_pg_ring),
              ("donation", audit_donation)]
    if dev.type == "cuda":
        checks.append(("host_sync", audit_host_sync))
    findings: List[Finding] = []
    for name, fn in checks:
        try:
            findings.extend(fn(dev))
        except Exception as e:  # noqa: BLE001 (a boundary: report, go on)
            findings.append(Finding(
                rule="wire-entry-error", severity="error", path=name,
                line=0, message=f"check raised {type(e).__name__}: {e}"))
    return findings
