"""Host-side profiling spans and trace capture (port of
``repro/obs/spans.py``, DESIGN.md §11).

``span("name")`` wraps a host-side region in a wall-clock timer
(``time.perf_counter``) and a ``torch.profiler.record_function``, so the
same name shows up in the span ledger this module keeps, in the JSONL event
log when a sink is installed, and on the profiler's timeline when a
``profile(...)`` capture is active.  The spans time the host: a region that
queues work on the card ends before the card does unless it synchronises.

``profile(log_dir)`` runs ``torch.profiler`` over the region (the CPU, and
CUDA where the card is there) and writes a Chrome trace
(``chrome://tracing``, Perfetto) into ``log_dir``; ``perfetto_artifacts``
finds it.  ``compile_execute_split`` times a first and a warm call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import time
from typing import List, Optional

import torch

_MAX_SPANS = 4096
TRACE_SUFFIX = ".pt.trace.json"


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    name: str
    t0: float        # perf_counter at entry (monotonic; deltas only)
    dur_s: float
    depth: int       # nesting level at entry


_SPANS: List[SpanRecord] = []
_DEPTH = [0]
_SINK = [None]      # optional EventLog; list cell so tests can swap it


def install_sink(log) -> None:
    """Mirror every closed span into ``log`` (an ``events.EventLog``)."""
    _SINK[0] = log


def uninstall_sink() -> None:
    _SINK[0] = None


def reset() -> None:
    _SPANS.clear()


def records() -> List[SpanRecord]:
    return list(_SPANS)


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
