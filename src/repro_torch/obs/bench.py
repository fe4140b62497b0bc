"""An append-only benchmark ledger with a tolerance regression gate (port
of ``repro/obs/bench.py``, DESIGN.md §11), on a path the caller gives.

The repo's ``BENCH_*.json`` files are snapshots each PR overwrites — useful
as documentation, useless as a gate.  This ledger is the complement: every
CI smoke run *appends* one line per benchmark metric (name, value, unit,
direction, tolerance, run-id, git sha), and ``check()`` fails the run when
the newest value regresses beyond tolerance against the best prior entry
in its window.  Deterministic metrics (compile counts, wire bytes, schema
errors) ride the same ledger with ``tol=0`` — any drift fails.

Directions: ``lower`` (timings, bytes, loss) and ``higher`` (throughput).
Tolerance is relative (0.25 == 25% worse than the best recent entry
fails); noise-prone wall-clock metrics should carry generous tolerances —
the gate is for order-of-magnitude rot, not microbenchmark jitter.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.obs.events import git_sha

DIRECTIONS = ("lower", "higher")
WINDOW = 20          # prior entries per metric considered by the gate


@dataclasses.dataclass(frozen=True)
class Verdict:
    name: str
    status: str              # 'ok' | 'regression' | 'baseline'
    latest: float
    best: Optional[float]    # best prior entry in the window (None: first)
    tol: float
    direction: str

    def describe(self) -> str:
        if self.status == "baseline":
            return f"{self.name}: baseline {self.latest:g}"
        rel = (0.0 if self.best in (None, 0.0)
               else (self.latest - self.best) / abs(self.best))
        return (f"{self.name}: {self.status} latest={self.latest:g} "
                f"best={self.best:g} ({rel:+.1%}, tol {self.tol:.0%} "
                f"{self.direction})")


def append(path: str, name: str, value: float, unit: str, *,
           direction: str = "lower", tol: float = 0.25,
           run_id: str = "", meta: Optional[dict] = None) -> dict:
    if direction not in DIRECTIONS:
        raise ValueError(f"direction {direction!r} not in {DIRECTIONS}")
    entry = {"name": name, "value": float(value), "unit": unit,
             "direction": direction, "tol": float(tol), "t": time.time(),
             "run_id": run_id, "git_sha": git_sha()}
    if meta:
        entry["meta"] = meta
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    return entry


def load(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad ledger line: {e}") from e
    return out


def check(path: str, names: Optional[List[str]] = None,
          window: int = WINDOW) -> List[Verdict]:
    """Gate the newest entry of each metric against the best of its prior
    ``window`` entries.  Returns one Verdict per metric (file order)."""
    by_name: Dict[str, List[dict]] = {}
    for e in load(path):
        by_name.setdefault(e["name"], []).append(e)
    verdicts = []
    for name, entries in by_name.items():
        if names is not None and name not in names:
            continue
        latest = entries[-1]
        prior = entries[:-1][-window:]
        direction = latest.get("direction", "lower")
        tol = float(latest.get("tol", 0.25))
        if not prior:
            verdicts.append(Verdict(name, "baseline", latest["value"], None,
                                    tol, direction))
            continue
        vals = [p["value"] for p in prior]
        best = min(vals) if direction == "lower" else max(vals)
        if direction == "lower":
            bad = latest["value"] > best * (1.0 + tol) + 1e-12
        else:
            bad = latest["value"] < best * (1.0 - tol) - 1e-12
        verdicts.append(Verdict(name, "regression" if bad else "ok",
                                latest["value"], best, tol, direction))
    return verdicts


def regressions(path: str, window: int = WINDOW) -> List[Verdict]:
    return [v for v in check(path, window=window) if v.status == "regression"]
