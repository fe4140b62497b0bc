"""Host-side profiling spans, the step's phases, and trace capture (port
of ``repro/obs/spans.py``, DESIGN.md §11).

``span("name")`` wraps a host-side region in a wall-clock timer
(``time.perf_counter``) and a ``torch.profiler.record_function``, so the
same name shows up in the span ledger this module keeps, in the JSONL event
log when a sink is installed, and on the profiler's timeline when a
``profile(...)`` capture is active.  The spans time the host: a region that
queues work on the card ends before the card does unless it synchronises.

``phase("name", **counts)`` marks a part of the training step
(``core/dist.py``, ``models/model.py``, ``models/remat.py``) on the device.
While no ``torch.profiler`` runs it checks that once and does nothing else.
While one runs, each boundary appends to a bounded log (``phases()``) and
launches a marker, ``phase_mark_kernel`` (``csrc/phase_mark.cu``, one thread
and no arguments, built and loaded at the first marker a capture needs), on
the current stream.  The program issues its work on that one stream, so in
the device trace every operation belongs to the phase that the marker
before it opened: the log's boundaries, in order, are the trace's markers,
in order.  A phase's ``backward(x, y)`` hooks a block's input and output
(only while a capture runs and ``x`` takes a gradient): the output's
gradient opens the block's backward record, and the input's, once whole,
closes it, so the block's backward operations fall between those markers
too.  Hooks leave the graph as it is (an identity ``autograd.Function``
would add a node, and under ``torch.func``'s ``vmap`` and ``grad`` each
costs the host about a millisecond).  A record's ``pass_`` is
``forward`` outside the autograd engine, ``backward`` inside it, and
``recompute`` for a phase entered inside it (remat's recompute of a layer).
A phase calls no ``record_function``: under a device-only profiler torch
may report an annotation as a device event.  A capture that times the step
as it runs untraced keeps the phases off with ``no_phases()``.

``profile(log_dir)`` runs ``torch.profiler`` over the region (the CPU, and
CUDA where the card is there) and writes a Chrome trace
(``chrome://tracing``, Perfetto) into ``log_dir``; ``perfetto_artifacts``
finds it.  ``compile_execute_split`` times a first and a warm call.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import pathlib
import time
from typing import Dict, List, Optional

import torch

_MAX_SPANS = 4096
# phase records kept (the oldest dropped): a 5-s stretch of the heaviest
# step, about 11 steps of 83 records, many times over
_MAX_PHASES = 1 << 16
TRACE_SUFFIX = ".pt.trace.json"
MARKER = "phase_mark_kernel"        # the marker's name in a device trace
FORWARD, BACKWARD, RECOMPUTE = "forward", "backward", "recompute"


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    name: str
    t0: float        # perf_counter at entry (monotonic; deltas only)
    dur_s: float
    depth: int       # nesting level at entry


@dataclasses.dataclass(eq=False, slots=True)
class PhaseRecord:
    """A phase of the step: the enclosing phase, the step
    (``phase("step", step=k)`` sets it for everything inside), the pass at
    entry and at exit, the order of its two markers among all phase
    markers (``seq``, ``end_seq``), and the counts given to it."""
    name: str
    parent: Optional[str]
    step: Optional[int]
    pass_: str
    seq: int
    counts: Dict
    end_pass: Optional[str] = None
    end_seq: int = -1


_SPANS: List[SpanRecord] = []
_DEPTH = [0]
_SINK = [None]      # optional EventLog; list cell so tests can swap it

_PHASES: collections.deque = collections.deque(maxlen=_MAX_PHASES)
_OPEN: List[PhaseRecord] = []       # open phases, innermost last
_SEQ = itertools.count()
_RECOMPUTING = [0]                  # open phases entered inside a backward
_QUIET = [0]                        # open no_phases() regions


def install_sink(log) -> None:
    """Mirror every closed span into ``log`` (an ``events.EventLog``)."""
    _SINK[0] = log


def uninstall_sink() -> None:
    _SINK[0] = None


def reset() -> None:
    _SPANS.clear()
    _PHASES.clear()
    _OPEN.clear()
    _RECOMPUTING[0] = 0


def records() -> List[SpanRecord]:
    return list(_SPANS)


def phases() -> List[PhaseRecord]:
    """The phase log, oldest first (the last ``_MAX_PHASES`` records)."""
    return list(_PHASES)


def total(name: str) -> float:
    """Summed duration of every closed span called ``name`` (seconds)."""
    return sum(r.dur_s for r in _SPANS if r.name == name)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a host-side region; mirrors into the profiler timeline + sink."""
    t0 = time.perf_counter()
    _DEPTH[0] += 1
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _DEPTH[0] -= 1
        dur = time.perf_counter() - t0
        if len(_SPANS) >= _MAX_SPANS:      # bounded: drop oldest
            del _SPANS[: _MAX_SPANS // 2]
        _SPANS.append(SpanRecord(name, t0, dur, _DEPTH[0]))
        if _SINK[0] is not None:
            _SINK[0].emit("span", name=name, dur_s=dur, depth=_DEPTH[0],
                          **attrs)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

_LAUNCH = [None]     # the marker's entry point, loaded at its first use


def _mark() -> None:
    """One marker on the current stream, where this process uses the card."""
    if not torch.cuda.is_initialized():
        return
    from repro_torch.kernels import _build
    if _LAUNCH[0] is None:
        _LAUNCH[0] = _build.load("phase_mark").phase_mark
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    _build.check("phase_mark", _LAUNCH[0](stream))


def _pass_now() -> str:
    if torch._C._current_graph_task_id() == -1:
        return FORWARD
    return RECOMPUTE if _RECOMPUTING[0] else BACKWARD


def _enter(name: str, pass_: str, step: Optional[int],
           counts: Dict) -> PhaseRecord:
    parent = _OPEN[-1] if _OPEN else None
    if step is None and parent is not None:
        step = parent.step
    rec = PhaseRecord(name, parent.name if parent else None, step, pass_,
                      next(_SEQ), counts)
    _OPEN.append(rec)
    _PHASES.append(rec)
    _mark()
    return rec


def _exit(rec: PhaseRecord) -> None:
    if rec in _OPEN:
        # a backward record whose input never took its gradient is left
        # open, without an exit: the readers refuse a step that holds one
        while _OPEN.pop() is not rec:
            pass
    if rec.pass_ == RECOMPUTE:
        _RECOMPUTING[0] -= 1
    rec.end_pass = _pass_now()
    rec.end_seq = next(_SEQ)
    _mark()


class _Block:
    """A block's backward record, opened and closed by gradient hooks."""
    __slots__ = ("name", "counts", "rec")

    def __init__(self, name: str, counts: Dict):
        self.name, self.counts, self.rec = name, counts, None

    def open(self, grad):
        self.rec = _enter(self.name, BACKWARD, None, dict(self.counts))

    def close(self, grad):
        if self.rec is not None:
            _exit(self.rec)
            self.rec = None


class phase:
    """The phase ``name`` of the step around a region, with ``counts``
    (numbers computed on the host) in its record; ``step`` names the step
    for everything inside.  Only while a profiler runs: a record in the
    log and a marker on the device at each end."""
    __slots__ = ("name", "step", "counts", "rec")

    def __init__(self, name: str, step: Optional[int] = None, **counts):
        self.name, self.step, self.counts = name, step, counts
        self.rec = None

    def __enter__(self):
        if not torch.autograd._profiler_enabled() or _QUIET[0]:
            return self
        pass_ = _pass_now()
        if pass_ != FORWARD:
            pass_ = RECOMPUTE
            _RECOMPUTING[0] += 1
        self.rec = _enter(self.name, pass_, self.step, self.counts)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            _exit(self.rec)
        return False

    def backward(self, x: torch.Tensor, y: torch.Tensor, **counts) -> None:
        """Make the backward of the block from ``x`` to ``y`` a record too,
        with ``counts``, while a capture runs and ``x`` takes a gradient:
        ``y``'s gradient opens it, and ``x``'s, once whole, closes it."""
        if self.rec is not None and torch.is_grad_enabled() \
                and x.requires_grad and y.requires_grad:
            block = _Block(self.name, counts)
            y.register_hook(block.open)
            x.register_hook(block.close)


def count(**counts) -> None:
    """Add ``counts`` to the record of the innermost open phase, where one
    is open: numbers known only inside the region, where it is run."""
    if _OPEN:
        _OPEN[-1].counts.update(counts)


def counting() -> bool:
    """Whether a phase is open to take ``count``'s counts (a capture
    runs): a count that costs device work is made only then."""
    return bool(_OPEN)


def plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the plain tensor under ``torch.func``'s transforms (its
    ``vmap``'s rows all there), detached: a count made inside them that
    may outlive them.  A 0-d device count is read (synchronising) only
    when the log is."""
    F = torch._C._functorch
    while F.is_functorch_wrapped_tensor(t):
        t = F.get_unwrapped(t)
    return t.detach()


@contextlib.contextmanager
def no_phases():
    """Keep ``phase`` off inside, a profiler running or not: for a capture
    that times the step as it runs untraced."""
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a Chrome trace of the wrapped region into ``log_dir``
    (``torch.profiler``: the CPU's ops, and the card's kernels when CUDA is
    there); yields the directory path."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    name = f"trace_{os.getpid()}_{time.time_ns()}{TRACE_SUFFIX}"
    prof.export_chrome_trace(os.path.join(str(log_dir), name))


def perfetto_artifacts(log_dir: str) -> List[str]:
    """The Chrome trace files a ``profile`` capture wrote, newest first."""
    root = pathlib.Path(log_dir)
    if not root.is_dir():
        return []
    hits = sorted(root.rglob(f"*{TRACE_SUFFIX}"),
                  key=lambda p: p.stat().st_mtime, reverse=True)
    return [str(p) for p in hits]


def _finish() -> None:
    """Wait for the card, where this process has used it (a call's time
    ends when its work does)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def compile_execute_split(fn, *args) -> dict:
    """Time ``fn``'s first call (its one-time work: kernel builds, caches,
    allocations) against a warm call, under the spans ``obs/compile`` and
    ``obs/execute``; each ends in a synchronise where the process has
    used the card.  Returns the two durations."""
    with span("obs/compile"):
        fn(*args)
        _finish()
    with span("obs/execute"):
        fn(*args)
        _finish()
    return {"compile_s": _SPANS[-2].dur_s - _SPANS[-1].dur_s,
            "first_call_s": _SPANS[-2].dur_s,
            "execute_s": _SPANS[-1].dur_s}


def summarize_spans(recs: Optional[List[SpanRecord]] = None) -> List[dict]:
    """Aggregate by name: count, total, mean, max (sorted by total desc)."""
    recs = _SPANS if recs is None else recs
    agg = {}
    for r in recs:
        a = agg.setdefault(r.name, {"name": r.name, "count": 0,
                                    "total_s": 0.0, "max_s": 0.0})
        a["count"] += 1
        a["total_s"] += r.dur_s
        a["max_s"] = max(a["max_s"], r.dur_s)
    for a in agg.values():
        a["mean_s"] = a["total_s"] / a["count"]
    return sorted(agg.values(), key=lambda a: -a["total_s"])
