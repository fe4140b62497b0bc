"""The program's phase records one by one in the device trace.

``portbench/phases.py`` sums the device time by the names of the open
phases; a reader that must tell two records of one name apart by their
counts (a windowed attention from a full one) takes each record's own
time here.  ``record_ns`` walks the same markers in the same order: every
operation's time goes to each record open at the marker before it (the
markers' own left out).  None where the program has no phase log (an older
port) or the markers and the log do not agree in number or nesting.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from portbench import phases
from portbench.trace import Trace

KEY = "records"


def chosen(trace: Trace) -> Optional[list]:
    """The records of the traced stretch's steps, in log order."""
    log = phases._log()
    if log is None or not trace.steps:
        return None
    recs = phases.last_steps(log[0], trace.steps)
    if not recs or any(r.end_seq < 0 for r in recs):
        return None
    return recs


def record_ns(trace: Trace) -> Optional[List[Tuple[object, int]]]:
    """[(record, device ns while it was open)] over the stretch."""
    if KEY not in trace.context:
        trace.context[KEY] = _record_ns(trace)
    return trace.context[KEY]


def _record_ns(trace: Trace):
    recs = chosen(trace)
    if recs is None:
        return None
    marker = phases._log()[1]
    bounds = sorted([(r.seq, r, True) for r in recs]
                    + [(r.end_seq, r, False) for r in recs],
                    key=lambda b: b[0])
    ns = {id(r): 0 for r in recs}
    stack: list = []
    k = 0
    for o in sorted(trace.ops, key=lambda o: o.start_ns):
        if o.kind == "kernel" and marker in o.name:
            if k == len(bounds):
                return None
            _, rec, enter = bounds[k]
            k += 1
            if enter:
                stack.append(rec)
            elif not stack or stack.pop() is not rec:
                return None
        else:
            for r in stack:
                ns[id(r)] += o.dur_ns
    if k != len(bounds):
        return None
    return [(r, ns[id(r)]) for r in recs]
