"""The comparison that decides ``correct``: the program's first steps against
the plain reference's, from the same weights, batches and uniforms.

Each number is a relative gap between two norms, the program's and the
reference's (not the norm of their difference), taken at the worst leaf:
``|prog - ref| / max(ref, median of the reference's leaves)``, since some
leaves' norms are all but zero.

* ``loss_gap``: the worst of the checked steps' losses.
* ``grad_gap``: the first step's gradient as the optimizer took it (the
  program's from Adam's first moment after one step, ``m / (1 - b1)``),
  per leaf.
* ``change_gap``: each leaf's change over the checked steps, per leaf,
  leaving out the leaves whose first raw gradient in the reference is
  under a thousandth of the median leaf's (round-off moves them).
* ``h_gap``, ``hbar_gap`` (cells with the wire): the workers' memories
  after the checked steps, per worker, and the server's memory.

A number whose limit (``portbench/limits/<cell>.json``) is null is printed
and not judged.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

EXCLUDE_BELOW = 1e-3


def _worst(prog: List[float], ref: List[float],
           keep: Optional[List[bool]] = None) -> float:
    med = statistics.median(ref)
    worst = 0.0
    for i, (p, r) in enumerate(zip(prog, ref)):
        if keep is not None and not keep[i]:
            continue
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(abs(r), med, 1e-30))
    return worst


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, from the two sides' readings."""
    med = statistics.median(ref["raw_grad_norms"])
    keep = [g >= EXCLUDE_BELOW * med for g in ref["raw_grad_norms"]]
    out = {
        "loss_gap": max(_worst([p], [r]) for p, r in
                        zip(prog["losses"], ref["losses"])),
        "grad_gap": _worst(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": _worst(prog["change_norms"], ref["change_norms"],
                             keep),
    }
    if "h_norms" in ref:
        out["h_gap"] = _worst(prog["h_norms"], ref["h_norms"])
        out["hbar_gap"] = _worst([prog["hbar_norm"]], [ref["hbar_norm"]])
    return out


def judge(numbers: Dict[str, float],
          limits: Dict[str, Optional[float]]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number
    with a limit lies at or under it."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit (not even null) for {name!r}")
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not value <= limit:
            ok = False
    return ok, checks


def lines(checks: Dict) -> List[str]:
    """One line a number: its name, its value and its limit."""
    return [f"{name} {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]
