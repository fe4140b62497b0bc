"""The program's own phases in the device trace.

While a profiler runs, the port marks the parts of its step
(``repro_torch/obs/spans.py::phase``): each boundary appends to a log on
the host (``spans.phases()``: name, parent, pass, step, counts, the
markers' order) and launches a marker, ``phase_mark_kernel``, on the stream
that carries the step.  ``split`` matches those markers in ``Trace.ops``,
in order, to the boundaries of the last ``trace.steps`` steps of the log,
in order, and gives every other operation the phases open at the marker
before it (outermost first) and the pass there (forward, backward,
recompute).  The markers' own time is left out.  The result is cached in
``trace.context``; it is None where the program has no phases (an older
port) or the markers and the log do not agree in number or nesting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from portbench.trace import Trace

KEY = "phases"
Path = Tuple[str, ...]            # the open phases, outermost first


@dataclasses.dataclass
class Split:
    steps: int
    names: set                    # every phase in the stretch
    device_ns: Dict[Tuple[Path, Optional[str]], int]   # (path, pass) -> ns
    counts: Dict[str, float]      # the records' counts, summed
    markers: int                  # the program's markers in the stretch

    def device_ms(self, names, pass_=None) -> Optional[float]:
        """Device ms a step of the operations inside any of ``names``, in
        ``pass_`` (any pass where None); None where no such phase ran."""
        if not self.names & set(names):
            return None
        ns = sum(v for (path, p), v in self.device_ns.items()
                 if set(path) & set(names) and pass_ in (None, p))
        return ns / 1e6 / self.steps


def split(trace: Trace) -> Optional[Split]:
    if KEY not in trace.context:
        trace.context[KEY] = _split(trace)
    return trace.context[KEY]


def _log():
    """The program's phase log and marker name; None for a port without."""
    try:
        from repro_torch.obs import spans
        return spans.phases(), spans.MARKER
    except (ImportError, AttributeError):
        return None


def last_steps(records, n: int):
    """The records of the log's last ``n`` steps (a contiguous tail), or
    None where it holds fewer."""
    tail, ids = [], set()
    for r in reversed(records):
        if r.step not in ids:
            if len(ids) == n:
                break
            ids.add(r.step)
        tail.append(r)
    if len(ids) < n or None in ids:
        return None
    return tail[::-1]


def _split(trace: Trace) -> Optional[Split]:
    log = _log()
    if log is None or not trace.steps:
        return None
    records, marker = log
    chosen = last_steps(records, trace.steps)
    if not chosen or any(r.end_seq < 0 for r in chosen):
        return None
    bounds = sorted([(r.seq, r, True) for r in chosen]
                    + [(r.end_seq, r, False) for r in chosen],
                    key=lambda b: b[0])
    ops = sorted(trace.ops, key=lambda o: o.start_ns)
    device: Dict[Tuple[Path, Optional[str]], int] = {}
    stack: list = []
    path: Path = ()
    pass_: Optional[str] = None
    k = 0
    for o in ops:
        if o.kind == "kernel" and marker in o.name:
            if k == len(bounds):
                return None
            _, rec, enter = bounds[k]
            k += 1
            if enter:
                stack.append(rec)
                pass_ = rec.pass_
            else:
                if not stack or stack[-1] is not rec:
                    return None
                stack.pop()
                pass_ = rec.end_pass
            path = tuple(r.name for r in stack)
        else:
            device[(path, pass_)] = device.get((path, pass_), 0) + o.dur_ns
    if k != len(bounds):
        return None
    counts: Dict[str, float] = {}
    for r in chosen:
        for name, v in r.counts.items():
            counts[name] = counts.get(name, 0.0) + float(v)
    return Split(trace.steps, {r.name for r in chosen}, device, counts, k)


def device_ms(trace: Trace, *names: str, pass_=None) -> Optional[float]:
    s = split(trace)
    return None if s is None else s.device_ms(names, pass_)


def count_per_step(trace: Trace, name: str) -> Optional[float]:
    """The records' count ``name`` summed over the stretch, a step."""
    s = split(trace)
    if s is None or name not in s.counts:
        return None
    return s.counts[name] / s.steps
