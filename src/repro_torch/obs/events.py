"""Structured JSONL event sink + schema + summaries (port of
``repro/obs/events.py``, DESIGN.md §11; the same schema, field for field).

One run = one append-only ``events.jsonl``.  Every line is a JSON object
with the envelope fields ``ev`` (event type), ``t`` (unix seconds),
``run_id``; each event type adds its required payload (``SCHEMA`` below is
the single source of truth, and what ``python -m repro_torch.obs validate``
checks).  Telemetry metric names inside ``eval`` events must exist in the
``obs.telemetry`` catalogue — a typo'd metric is a schema error, not a
silently ignored key.

Feeding discipline: the round loop never calls into this module.  The
sweep returns its telemetry with the eval series at the end of the run;
``record_sweep`` then writes them on the host.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
import uuid
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.obs import telemetry as T

SCHEMA_VERSION = 1

# required payload fields per event type (envelope ev/t/run_id implied)
SCHEMA: Dict[str, tuple] = {
    "run_start": ("config", "fingerprint", "git_sha"),
    "eval": ("cell", "iter", "loss", "bits", "dist"),
    "telemetry": ("cell", "iter", "metrics"),
    "span": ("name", "dur_s"),
    "train_step": ("step", "loss", "wall_s"),
    "wire": ("wire", "reduce_impl", "measured_bytes", "model_bytes"),
    "rollback": ("step", "count"),
    "note": ("text",),
    "bench": ("name", "value", "unit"),
    "run_end": ("status", "wall_s"),
}


def git_sha(repo: Optional[str] = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo,
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "tolist"):            # tensors land here
        return x.tolist()
    raise TypeError(f"not JSON-serializable: {type(x).__name__}")


def validate_event(rec: dict) -> List[str]:
    """Schema errors of one event record ([] == valid)."""
    errs = []
    ev = rec.get("ev")
    if ev not in SCHEMA:
        return [f"unknown event type {ev!r}"]
    for field in ("t", "run_id"):
        if field not in rec:
            errs.append(f"{ev}: missing envelope field {field!r}")
    for field in SCHEMA[ev]:
        if field not in rec:
            errs.append(f"{ev}: missing required field {field!r}")
    if ev in ("eval", "telemetry"):
        for name, v in (rec.get("metrics") or {}).items():
            if name not in T._CATALOGUE:
                errs.append(f"{ev}: metric {name!r} not in the catalogue")
            elif T.get(name).kind == "hist" and not isinstance(v, list):
                errs.append(f"{ev}: hist metric {name!r} must be a list")
            elif T.get(name).kind != "hist" and isinstance(v, list):
                errs.append(f"{ev}: scalar metric {name!r} got a list")
    return errs


class EventLog:
    """Append-only JSONL sink; validates on write, flushes per event.

    ``path=None`` makes an echo-only sink: events are validated and printed
    but not persisted — how entry points route their console output
    through the schema even when the user asked for no log file.
    """

    def __init__(self, path: Optional[str] = None,
                 run_id: Optional[str] = None, echo: bool = False):
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.echo = echo or path is None
        self._f = open(path, "a") if path is not None else None

    def emit(self, ev: str, **fields) -> dict:
        rec = {"ev": ev, "t": time.time(), "run_id": self.run_id, **fields}
        errs = validate_event(rec)
        if errs:
            raise ValueError(f"invalid {ev!r} event: {errs}")
        line = json.dumps(rec, default=_jsonable)
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            # the sanctioned console mirror — library code routes human
            # output through here instead of bare prints (astlint
            # print-in-library)
            print(line)        # repro-lint: allow=print-in-library
        return rec

    def start(self, config: dict, fingerprint: str = "",
              repo: Optional[str] = None, **extra) -> dict:
        return self.emit("run_start", config=config, fingerprint=fingerprint,
                         git_sha=git_sha(repo), schema=SCHEMA_VERSION,
                         **extra)

    def end(self, status: str = "ok", wall_s: float = 0.0, **extra) -> dict:
        return self.emit("run_end", status=status, wall_s=wall_s, **extra)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_events(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad JSON line: {e}") from e
    return out


def validate_events(events: Iterable[dict]) -> List[str]:
    errs = []
    for i, rec in enumerate(events):
        errs.extend(f"event {i}: {e}" for e in validate_event(rec))
    return errs


def record_sweep(log: EventLog, res, cfgs=None, labels=None,
                 every: int = 1) -> int:
    """Write a SweepResult's eval series (+ telemetry, if enabled) as
    ``eval`` events, on the host after the sweep returned.

    ``every`` thins the *event log* further (every-th eval point; the final
    point is always written).  Returns the number of events emitted.
    """
    V, G, S, E = res.losses.shape
    if labels is None:
        labels = ([f"{c.up}/{c.dwn}" + ("+ef" if c.error_feedback else "")
                   for c in cfgs] if cfgs is not None
                  else [f"v{v}" for v in range(V)])
    wrote = 0
    eidx = sorted(set(range(0, E, every)) | {E - 1})
    for v in range(V):
        for g in range(G):
            for s in range(S):
                for e in eidx:
                    metrics = None
                    if getattr(res, "telemetry", None):
                        metrics = {k: np.asarray(a[v, g, s, e]).tolist()
                                   for k, a in res.telemetry.items()}
                    log.emit(
                        "eval",
                        cell={"v": v, "g": g, "s": s, "label": labels[v]},
                        iter=int(res.eval_iters[e]),
                        loss=float(res.losses[v, g, s, e]),
                        bits=float(res.bits[v, g, s, e]),
                        dist=float(res.dists[v, g, s, e]),
                        **({"metrics": metrics} if metrics else {}))
                    wrote += 1
                rbs = int(np.asarray(res.rollbacks[v, g, s]))
                if rbs:
                    log.emit("rollback", step=int(res.eval_iters[-1]),
                             count=rbs,
                             cell={"v": v, "g": g, "s": s,
                                   "label": labels[v]})
                    wrote += 1
    return wrote


def _cell_key(rec: dict) -> tuple:
    c = rec["cell"]
    return (c.get("v", 0), c.get("g", 0), c.get("s", 0))


def summarize(events: List[dict]) -> dict:
    """Digest of one event log: run identity, per-cell final numbers,
    span totals, fault/rollback tallies, schema health."""
    by_type: Dict[str, int] = {}
    for rec in events:
        by_type[rec.get("ev", "?")] = by_type.get(rec.get("ev", "?"), 0) + 1
    start = next((r for r in events if r.get("ev") == "run_start"), None)
    end = next((r for r in reversed(events) if r.get("ev") == "run_end"),
               None)
    cells: Dict[tuple, dict] = {}
    for rec in events:
        if rec.get("ev") != "eval":
            continue
        k = _cell_key(rec)
        c = cells.setdefault(k, {"label": rec["cell"].get("label", ""),
                                 "evals": 0})
        c["evals"] += 1
        if c.get("iter", -1) <= rec["iter"]:     # last eval point wins
            c.update(iter=rec["iter"], loss=rec["loss"], bits=rec["bits"],
                     dist=rec["dist"])
            if "metrics" in rec:
                c["metrics"] = rec["metrics"]
    spans = {}
    for rec in events:
        if rec.get("ev") != "span":
            continue
        a = spans.setdefault(rec["name"], {"count": 0, "total_s": 0.0})
        a["count"] += 1
        a["total_s"] += rec["dur_s"]
    rollbacks = sum(r["count"] for r in events if r.get("ev") == "rollback")
    return {
        "run_id": events[0].get("run_id") if events else None,
        "git_sha": (start or {}).get("git_sha"),
        "fingerprint": (start or {}).get("fingerprint"),
        "status": (end or {}).get("status"),
        "wall_s": (end or {}).get("wall_s"),
        "events": by_type,
        "schema_errors": validate_events(events),
        "cells": {"/".join(map(str, k)): v for k, v in sorted(cells.items())},
        "spans": spans,
        "rollbacks": rollbacks,
    }
