"""The benchmark's device trace: ``torch.profiler`` over a stretch of steps
after the measured window, recording the device's activity alone, reduced
to the device's operations, each with the harness's range it ran in.

The profiler still costs the host some microseconds a launch, so a traced
step lasts longer than an untraced one where the host paces it.  What the
trace gives is the device's work a step; what a step lasts is the
untraced window's (``context["paced"]``), and the readers divide the one by
the other.  One step runs under the profiler before the stretch, so its
start-up falls outside; a marker opens the stretch.

The harness marks two of the program's calls as ranges (``span``: ``GRADS``
around the per-worker gradients, ``OPTIM`` around the optimizer's update).
While a trace runs, entering or leaving a range launches a marker on the
current stream, a one-cycle ``spin_kernel`` (``torch.cuda._sleep``), and
the host notes which range the marker opens (the enclosing one, or
``None``, on leaving).  The program launches all its work on that one
stream, so the device runs the markers in the order the host noted them,
and every other operation belongs to the range the marker before it
opened.  The markers are not the step's work and are left out.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

GRADS, OPTIM = "portbench/grads", "portbench/optim"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
MARK_CYCLES = 1

_marks: Optional[List[Optional[str]]] = None     # while a trace runs
_open: List[str] = []


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str                 # kernel | gpu_memcpy | gpu_memset
    start_ns: int
    dur_ns: int
    range: Optional[str]      # GRADS, OPTIM or None


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    steps: int                # steps inside the traced stretch
    window_s: float           # the traced stretch, host clock
    context: Dict             # what the cell's readers need (flops, shapes,
                              # the untraced window's steps and seconds)

    def kernels(self) -> List[DeviceOp]:
        return [o for o in self.ops if o.kind == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in merged(self.ops)) / 1e9


def _mark(name: Optional[str]) -> None:
    import torch
    torch.cuda._sleep(MARK_CYCLES)
    _marks.append(name)


@contextlib.contextmanager
def span(name: str):
    """The range ``name`` around a call: a marker on the device at each end
    while a trace runs, nothing otherwise."""
    if _marks is None:
        yield
        return
    _open.append(name)
    _mark(name)
    try:
        yield
    finally:
        _open.pop()
        _mark(_open[-1] if _open else None)


def merged(ops: List[DeviceOp]) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, sorted."""
    out: List[List[int]] = []
    for a, b in sorted((o.start_ns, o.start_ns + o.dur_ns) for o in ops):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _kind(e) -> str:
    """A device event's Kineto activity type; where torch does not expose
    it (2.11), told by the name."""
    try:
        return str(e.activity_type())
    except AttributeError:
        pass
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce_events(events, marks: List[Optional[str]]) -> List[DeviceOp]:
    """Kineto's events -> the device operations after the first marker, in
    the order they ran, each with the range that the markers before it
    opened (``marks``: the range each marker opened, in the order they
    were launched)."""
    device = sorted(((e, _kind(e)) for e in events
                     if "CUDA" in str(e.device_type())),
                    key=lambda ek: ek[0].start_ns())
    ops: List[DeviceOp] = []
    at: Optional[str] = None
    seen = 0
    for e, kind in device:
        if kind not in DEVICE_KINDS:
            continue
        if kind == "kernel" and MARKER in e.name():
            if seen < len(marks):
                at = marks[seen]
            seen += 1
            continue
        if seen:
            ops.append(DeviceOp(e.name(), kind, e.start_ns(),
                                e.duration_ns(), at))
    if seen != len(marks):
        raise RuntimeError(f"the trace holds {seen} range markers, the "
                           f"host launched {len(marks)}")
    return ops


def traced(fn: Callable[[], Tuple[int, float]], warm: Callable[[], object],
           context: Dict) -> Trace:
    """Run ``warm`` (a step) and then ``fn`` (the stretch: returns its steps
    and host seconds) under the profiler, the device's activity recorded;
    the stretch opens with a marker, and its ranges are marked."""
    global _marks
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda.synchronize()
        _marks = []
        _mark(None)
        try:
            steps, window_s = fn()
        finally:
            marks, _marks = _marks, None
    ops = reduce_events(prof.profiler.kineto_results.events(), marks)
    del prof
    torch.cuda.synchronize()
    return Trace(ops, steps, window_s, context)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (summed by name), and the
    longest idle gaps, each named by when it ended in the stretch, the range
    and the operation that ended it (what the host was issuing while the
    device waited)."""
    by_name: Dict[str, int] = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0) + o.dur_ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    first = sorted(trace.ops, key=lambda o: o.start_ns)
    starts = [o.start_ns for o in first]
    gaps = []
    spans = merged(trace.ops)
    for (_, end), (nxt, _) in zip(spans, spans[1:]):
        o = first[bisect.bisect_left(starts, nxt)]
        label = {None: "outside", GRADS: "grads", OPTIM: "optim"}[o.range]
        at = (nxt - spans[0][0]) / 1e9
        gaps.append((f"{label} at +{at:.3f} s: before {o.name[:100]}",
                     nxt - end))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps[:top]]}
